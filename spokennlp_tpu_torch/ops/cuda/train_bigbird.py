"""Training BigBird attention block with hand-written forward and backward
kernels.

Counterpart of ``spokennlp_tpu/ops/pallas/train_bigbird.py``:
``bigbird_attention_block_train`` is the attention of
``ops/cuda/bigbird_block.py`` (window, global-column and random key blocks,
global rows dense) followed by the output projection, without the LayerNorm
epilogue, with dropout on the window, global-column, random and global-row
probabilities inside the kernels (``csrc/train_bigbird.cu``). Residual,
LayerNorm and hidden-state dropout stay in PyTorch.

On a CUDA tensor it runs the kernels through a ``torch.autograd.Function``
whose backward is a kernel too; the forward saves only its inputs and the
seed, and the backward recomputes the rest. On a CPU tensor it runs
``bigbird_train_plain`` (float32 PyTorch on the block-sparse formulation,
with explicit keep masks), whose gradient comes from autograd.

Dropout draws one Philox4x32-10 word per probability from four counter
spaces that never meet, the second word carrying the head and a tag:

    window keys     (b, h,           row, key)
    global columns  (b, h | 1 << 16, row, key)       key < G C
    global rows     (b, h | 2 << 16, row, key)       row < G C
    random blocks   (b, h | 3 << 16, row, r C + c)   the r-th random block's key c

and keeps a probability iff its bits are >= ``dropout_threshold(rate)``.
``bigbird_keep_masks`` gives the four masks on either device (the numpy twin
``philox_bits`` on the CPU), so the plain version replays the kernels'
dropout exactly. The TPU kernel's hardware-PRNG pattern cannot be matched bit
for bit, so parity with JAX runs at rate 0.

``bigbird_train_bwd_plain`` is the backward kernel written out, every
product through ``train_blocks.backward_product`` (no model path runs it;
the card checks hold the kernel's products to it). ``bigbird_core_bwd_model``
is the rounding model of its gradient kernels (the card checks hold the
kernels' dproj to it element by element).
"""

from __future__ import annotations

import numpy as np
import torch

from spokennlp_tpu_torch.ops.bigbird_attention import bigbird_tables
from spokennlp_tpu_torch.ops.cuda import attention_models as am
from spokennlp_tpu_torch.ops.cuda import build
from spokennlp_tpu_torch.ops.cuda import train_blocks as tb
from spokennlp_tpu_torch.ops.cuda.attention_block import _DTYPES
from spokennlp_tpu_torch.ops.cuda.bigbird_block import (
    bigbird_attend, bigbird_context_plain, card_weights, check_card_inputs,
)
from spokennlp_tpu_torch.ops.cuda.int8_matmul import float_product
from spokennlp_tpu_torch.ops.cuda.train_blocks import (
    _ptr, _stream, dropout_threshold, philox_bits, weight_grad_plan,
)
from spokennlp_tpu_torch.ops.cuda import train_sliding as ts
from spokennlp_tpu_torch.ops.cuda.train_sliding import (
    GLOBAL_COL_STREAM, GLOBAL_ROW_STREAM, _u32,
)

RANDOM_STREAM = 3 << 16


def bigbird_keep_masks(seed: torch.Tensor, B: int, nh: int, L: int, block_size: int, G: int,
                       R: int, rate: float):
    """(window (B, nh, nb, C, 3C), global columns (B, nh, L, G C), random
    (B, nh, L, R C), global rows (B, nh, G C, L)) bool: where the training
    kernels keep a probability for this (1,) int32 seed, on the seed's
    device. ``G`` and ``R`` are the pattern's (``bigbird_tables``). Window
    entry (i, ci, cj) is row i C + ci against key i C - C + cj; random entry
    (row, r C + c) is the row against the c-th key of its r-th random
    block."""
    C = block_size
    nb, GC, RC = L // C, G * C, R * C
    thr = dropout_threshold(rate)
    if seed.device.type == "cpu":
        s = int(seed.reshape(-1)[0])
        b, h, i, ci, cj = np.ix_(np.arange(B), np.arange(nh), np.arange(nb), np.arange(C),
                                 np.arange(3 * C))
        win = philox_bits(s, b, h, _u32(i * C + ci), _u32(i * C - C + cj))
        b, h, r, c = np.ix_(np.arange(B), np.arange(nh), np.arange(L), np.arange(GC))
        gcol = philox_bits(s, b, h | GLOBAL_COL_STREAM, r, c)
        b, h, r, c = np.ix_(np.arange(B), np.arange(nh), np.arange(L), np.arange(RC))
        rnd = philox_bits(s, b, h | RANDOM_STREAM, r, c)
        b, h, g, k = np.ix_(np.arange(B), np.arange(nh), np.arange(GC), np.arange(L))
        grow = philox_bits(s, b, h | GLOBAL_ROW_STREAM, g, k)
        return tuple(torch.from_numpy(m >= np.uint32(thr)) for m in (win, gcol, rnd, grow))
    masks = [torch.empty(shape, dtype=torch.uint8, device=seed.device)
             for shape in ((B, nh, nb, C, 3 * C), (B, nh, L, GC), (B, nh, L, RC), (B, nh, GC, L))]
    seed = seed.to(torch.int32).contiguous()
    with torch.cuda.device(seed.device):
        code = build.library().spk_bigbird_dropout_mask(
            seed.data_ptr(), *(m.data_ptr() for m in masks), B, nh, L, C, G, R, thr, _stream())
    build.check(code, "bigbird_keep_masks")
    return tuple(m.bool() for m in masks)


def bigbird_train_plain(
    hidden, attention_mask, qkv_kernel, qkv_bias, out_kernel, out_bias, *, sm_scale: float,
    block_size: int, num_global_blocks: int, num_random_blocks: int, pattern_seed: int,
    dropout_rate: float = 0.0, keep=None,
) -> torch.Tensor:
    """The training block in plain float32 PyTorch; returns hidden's dtype.
    ``keep`` (the four masks of ``bigbird_keep_masks``) is needed when
    ``dropout_rate`` > 0. The projections and the out projection go through
    ``float_product`` (this module's and bigbird_block's)."""
    if dropout_rate > 0.0 and keep is None:
        raise ValueError("bigbird_train_plain: dropout_rate > 0 needs the keep masks")
    ctx = bigbird_context_plain(
        hidden, attention_mask, qkv_kernel, qkv_bias, sm_scale=sm_scale, block_size=block_size,
        num_global_blocks=num_global_blocks, num_random_blocks=num_random_blocks,
        seed=pattern_seed, dropout_rate=dropout_rate, keep=keep,
    )
    B, L, H = hidden.shape
    out = float_product(ctx.reshape(B, L, -1), out_kernel.reshape(-1, H)) + out_bias.float()
    return out.to(hidden.dtype)


def bigbird_train_bwd_plain(
    hidden, attention_mask, qkv_kernel, qkv_bias, out_kernel, g, *, sm_scale: float,
    block_size: int, num_global_blocks: int, num_random_blocks: int, pattern_seed: int,
    dropout_rate: float = 0.0, keep=None, model_core: bool = False,
):
    """The backward kernel written out: the projections recomputed and
    rounded to hidden's dtype, dctx = g Wo^T rounded, the core's gradient
    (autograd of ``bigbird_attend`` in float32) rounded, then
    ``train_blocks.projection_grads_plain`` on the rounded ctx. Returns (dx,
    dWqkv (H, 3 Hn), dbqkv, dWo (Hn, H), dbo) as ``bigbird_train_bwd`` does;
    in float32 it is autograd of ``bigbird_train_plain``. ``model_core``:
    the core's gradient from ``bigbird_core_bwd_model`` instead, on q scaled
    before it is rounded and a ctx with the kernels' rounded exponent, as the
    kernels take them."""
    B, L, H = hidden.shape
    _, _, nh, hd = qkv_kernel.shape
    dt, M, HN = hidden.dtype, B * L, nh * hd
    x, g2 = hidden.reshape(M, H), g.reshape(M, H)
    wqkv, wo = qkv_kernel.reshape(H, 3 * HN), out_kernel.reshape(HN, H)
    pattern = dict(block_size=block_size, num_global_blocks=num_global_blocks,
                   num_random_blocks=num_random_blocks, seed=pattern_seed)
    if model_core:
        p = (tb.backward_product(x, wqkv) + qkv_bias.float().reshape(-1)).reshape(B, L, 3, nh, hd)
        q, k, v = (p[:, :, 0] * sm_scale).to(dt), p[:, :, 1].to(dt), p[:, :, 2].to(dt)
        dctx = tb.out_grad_plain(g2, wo)
        ctx = bigbird_attend(q, k, v, attention_mask, **pattern, exp_dtype=dt,
                             dropout_rate=dropout_rate, keep=keep).reshape(M, HN)
        tables = bigbird_tables(L // block_size, num_global_blocks, num_random_blocks,
                                pattern_seed, "cpu")
        heads = lambda t: t.transpose(1, 2)
        grads = bigbird_core_bwd_model(
            heads(q), heads(k), heads(v), dctx.reshape(B, L, nh, hd),
            (attention_mask > 0).sum(1), tables, block_size=block_size, sm_scale=sm_scale,
            dropout_rate=dropout_rate, keep=keep)
        dqkv = torch.stack(grads, dim=2).reshape(M, 3 * HN)
        dx, *grads = tb.projection_grads_plain(x, g2, ctx.to(dt), dqkv, wqkv, wo)
        return (dx.reshape(B, L, H), *grads)
    qkv = (tb.backward_product(x, wqkv) + qkv_bias.float().reshape(-1)).to(dt).float()
    with torch.enable_grad():
        qkv = qkv.requires_grad_()
        q, k, v = qkv.reshape(B, L, 3, nh, hd).unbind(2)
        ctx = bigbird_attend(q * sm_scale, k, v, attention_mask, **pattern,
                             dropout_rate=dropout_rate, keep=keep).reshape(M, HN)
        (dqkv,) = torch.autograd.grad(ctx, qkv, tb.out_grad_plain(g2, wo).float())
    dx, *grads = tb.projection_grads_plain(x, g2, ctx.detach().to(dt), dqkv.to(dt), wqkv, wo)
    return (dx.reshape(B, L, H), *grads)


# ------------------------------------------------- the gradient kernels' model

WINDOW, GLOBAL_COLUMN, RANDOM, GLOBAL_ROW = 1, 2, 3, 4  # the pieces of bigbird_model_regions


def bigbird_model_regions(L: int, C: int, G: int, R: int, rand: np.ndarray,
                          rok: np.ndarray) -> np.ndarray:
    """(L, L) int8: the piece through which each row reaches each key
    (WINDOW, GLOBAL_COLUMN, RANDOM or GLOBAL_ROW; 0 for none), before the
    real-key mask."""
    blk = np.arange(L) // C
    rows, keys = blk[:, None], blk[None, :]
    reg = np.zeros((L, L), np.int8)
    local = rows >= G
    reg[local & (np.abs(keys - rows) <= 1) & (keys >= G)] = WINDOW
    reg[local & (keys < G)] = GLOBAL_COLUMN
    for i in range(G, L // C):
        for r in range(R):
            if rok[i, r]:
                j = int(rand[i, r])
                reg[i * C:(i + 1) * C, j * C:(j + 1) * C] = RANDOM
    reg[:G * C] = GLOBAL_ROW
    return reg


def _bigbird_dense_keep(keep, b: int, reg, C: int, G: int, R: int, rand, rok):
    """The four keep masks of ``bigbird_keep_masks`` for sequence b as one
    dense (nh, L, L) mask over the regions ``reg`` of
    ``bigbird_model_regions``."""
    L, GC = reg.shape[0], G * C
    win, gcol, rnd, grow = (m[b] for m in keep)
    kd = ts.dense_band_keep(win, L, C) & (reg == WINDOW)
    kd[:, :, :GC] |= gcol & (reg[:, :GC] == GLOBAL_COLUMN)
    for i in range(G, L // C):
        for r in range(R):
            if rok[i, r]:
                j = int(rand[i, r])
                kd[:, i * C:(i + 1) * C, j * C:(j + 1) * C] = rnd[:, i * C:(i + 1) * C,
                                                                  r * C:(r + 1) * C]
    kd[:, :GC] = grow
    return kd


def bigbird_core_bwd_model(q, k, v, dctx, n_valid, tables, *, block_size: int, sm_scale: float,
                           stats=None, dropout_rate: float = 0.0, keep=None):
    """The rounding model of the BigBird backward's gradient kernels
    (bigbird_dq_kernel, bigbird_dkv_kernel), from the kernels' own q
    (scaled), k, v (B, nh, L, hd), dctx (B, L, nh, hd), n_valid (B,), the
    pattern's ``bigbird_tables``, the row statistics stats (3, B, nh, L)
    (None: taken here) and the four keep masks of ``bigbird_keep_masks``.
    Dense over a sequence's keys with float32 sums and no tiles; rounds
    where the kernels round (``attention_models.dense_core_grad``; dq before
    and after the scale, dk and dv once). Returns (dq, dk, dv), each (B, L,
    nh, hd) in q's dtype."""
    dt, dev = q.dtype, q.device
    B, nh, L, hd = q.shape
    C, G, R, kp = block_size, tables.G, tables.R, 1.0 - dropout_rate
    rand, rok = tables.rand.cpu().numpy(), tables.rok.cpu().numpy()
    reg = torch.from_numpy(bigbird_model_regions(L, C, G, R, rand, rok)).to(dev)
    tr = lambda t: t.transpose(-1, -2)
    outs = [torch.zeros(B, nh, L, hd, device=dev) for _ in range(3)]
    for b in range(B):
        allowed = (reg > 0) & (torch.arange(L, device=dev) < int(n_valid[b]))[None]
        kd = None if keep is None else _bigbird_dense_keep(keep, b, reg, C, G, R, rand, rok)
        qb, kb, vb = (t[b].float() for t in (q, k, v))
        dc = dctx[b].float().transpose(0, 1)
        ds, pe = am.dense_core_grad(qb @ tr(kb), dc @ tr(vb), allowed, kd,
                                    None if stats is None else stats[:, b], dt, kp)
        outs[0][b] = am.rounded(am.rounded(ds @ kb, dt) * sm_scale, dt)
        outs[1][b] = am.rounded(tr(ds) @ qb, dt)
        outs[2][b] = am.rounded(tr(pe) @ dc, dt)
    return tuple(o.transpose(1, 2).to(dt) for o in outs)


def bigbird_core_model_dproj(buffers: dict, tables, *, block_size: int, sm_scale: float,
                             dropout_rate: float = 0.0, keep=None) -> torch.Tensor:
    """The model's [dq dk dv] (B*L, 3 Hn) on the intermediates that
    ``bigbird_train_bwd`` put into ``buffers``: the layout of the kernel's
    dproj."""
    qkv = buffers["qkv"]
    B, nh, L, hd = qkv.shape[1:]
    grads = bigbird_core_bwd_model(
        qkv[0], qkv[1], qkv[2], buffers["dctx"].reshape(B, L, nh, hd),
        buffers["counts"].long()[:, 0], tables, block_size=block_size, sm_scale=sm_scale,
        stats=buffers["stats"], dropout_rate=dropout_rate, keep=keep)
    return torch.stack(grads, dim=2).reshape(B * L, -1)


def bigbird_rows_model(q, k, v, n_valid, tables, *, block_size: int, dctx=None,
                       dropout_rate: float = 0.0, keep=None, ctx_dtype=None):
    """The rounding model of bigbird_rows_kernel, the attention the BigBird
    blocks run, from the kernels' own q (scaled), k, v (B, nh, L, hd),
    n_valid (B,), the pattern's ``bigbird_tables`` and the four keep masks
    of ``bigbird_keep_masks``; with ``dctx`` (B, L, nh, hd) also
    rowsum(dp p_eff). Dense over a sequence's keys (its regions of
    ``bigbird_model_regions``) with float32 sums and no tiles; e rounded
    where the kernel rounds it (``attention_models.rows_exponent``, against the
    row's true maximum), ctx rounded to ``ctx_dtype`` (q's dtype by
    default). Returns ctx (B, L, nh, hd) and the row statistics (3, B, nh,
    L) float32 = (m, D, rowsum(dp p_eff)) (-inf, 0, 0 for a row with no
    allowed key; rs zero without dctx)."""
    dt, dev = q.dtype, q.device
    B, nh, L, hd = q.shape
    C, G, R, kp = block_size, tables.G, tables.R, 1.0 - dropout_rate
    rand, rok = tables.rand.cpu().numpy(), tables.rok.cpu().numpy()
    reg = torch.from_numpy(bigbird_model_regions(L, C, G, R, rand, rok)).to(dev)
    tr = lambda t: t.transpose(-1, -2)
    ctx = torch.zeros(B, nh, L, hd, device=dev)
    stats = torch.zeros(3, B, nh, L, device=dev)
    for b in range(B):
        allowed = (reg > 0) & (torch.arange(L, device=dev) < int(n_valid[b]))[None]
        kd = None if keep is None else _bigbird_dense_keep(keep, b, reg, C, G, R, rand, rok)
        qb, kb, vb = (t[b].float() for t in (q, k, v))
        dp = None if dctx is None else dctx[b].float().transpose(0, 1) @ tr(vb)
        c, m, D, rs = am.rows_attend(qb @ tr(kb), vb, allowed, kd, dt, kp, dp)
        ctx[b], stats[0, b], stats[1, b] = c, m, D
        if rs is not None:
            stats[2, b] = rs
    return ctx.transpose(1, 2).to(ctx_dtype or dt), stats


def bigbird_rows(qkv, counts, seed, tables, *, block_size: int, dctx=None,
                 dropout_rate: float = 0.0, ctx_dtype=None):
    """bigbird_rows_kernel alone: qkv (3, B, nh, L, hd) with q scaled, counts
    (B, 2) int32 (n_valid first), seed (1,) int32 (read at a rate above 0),
    the pattern's ``bigbird_tables`` and, for the statistics pass, dctx (B,
    L, nh hd). Returns ctx (B, L, nh, hd) in ``ctx_dtype`` (qkv's dtype, or
    float32 from bf16 q, k, v as the W8A8 block runs it) and, with dctx, the
    row statistics (3, B, nh, L) float32 (else None). On the CPU it runs
    ``bigbird_rows_model``; on the card the kernel, whose launches
    ``bigbird_rows.launches`` counts. No model path calls it: the blocks
    launch the kernel inside their own entries."""
    _, B, nh, L, hd = qkv.shape
    dt = qkv.dtype
    ctx_dtype = ctx_dtype or dt
    if qkv.device.type == "cpu":
        keep = None
        if dropout_rate > 0.0:
            keep = bigbird_keep_masks(seed, B, nh, L, block_size, tables.G, tables.R,
                                      dropout_rate)
        ctx, stats = bigbird_rows_model(
            qkv[0], qkv[1], qkv[2], counts.long()[:, 0], tables, block_size=block_size,
            dropout_rate=dropout_rate, keep=keep, ctx_dtype=ctx_dtype,
            dctx=None if dctx is None else dctx.reshape(B, L, nh, hd))
        return ctx, None if dctx is None else stats
    ctx = torch.empty(B, L, nh, hd, dtype=ctx_dtype, device=qkv.device)
    stats = None if dctx is None else torch.empty(3, B, nh, L, device=qkv.device)
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(qkv.device):
        code = build.library().spk_bigbird_rows(
            _DTYPES[dt], int(ctx_dtype != dt), int(dctx is not None), ptr(qkv), ptr(counts),
            ptr(tables.rand), ptr(tables.rok), ptr(seed), ptr(dctx), ptr(ctx), ptr(stats), B, L,
            nh, hd, block_size, tables.G, tables.R, dropout_threshold(dropout_rate),
            1.0 - dropout_rate, _stream())
    build.check(code, "bigbird_rows")
    bigbird_rows.launches += 1
    return ctx, stats


bigbird_rows.launches = 0


# ------------------------------------------------------------ kernel calls


def bigbird_train_fwd(hidden, mask, seed, w, bo, tables, *, num_heads: int, block_size: int,
                      sm_scale: float, dropout_rate: float, buffers: dict = None) -> torch.Tensor:
    """Forward kernel: hidden (B, L, H), the weights of ``card_weights`` ``w``,
    bo (H,) float32, mask (B, L) and seed (1,) int32 and the pattern's
    ``bigbird_tables``, all on one card. A ``buffers`` dict receives the
    projections qkv (3, B, nh, L, hd). ``bigbird_train_fwd.launches`` counts
    its launches."""
    B, L, H = hidden.shape
    HN = w["wo"].shape[0]
    hd = HN // num_heads
    dev, dt = hidden.device, hidden.dtype
    empty = lambda *s, dtype=dt: torch.empty(s, dtype=dtype, device=dev)
    counts, qkv_buf, ctx_buf = (empty(B, 2, dtype=torch.int32), empty(3, B, num_heads, L, hd),
                                empty(B, L, HN))
    out = torch.empty_like(hidden)
    with torch.cuda.device(dev):
        code = build.library().spk_bigbird_train_fwd(
            _DTYPES[dt], *(t.data_ptr() for t in (hidden, mask, tables.rand, tables.rok, seed,
                                                  w["wqkv"], w["bqkv"], w["wo"], bo, counts,
                                                  qkv_buf, ctx_buf, out)),
            B, L, H, num_heads, hd, block_size, tables.G, tables.R, float(sm_scale),
            dropout_threshold(dropout_rate), 1.0 - dropout_rate, _stream(),
        )
    build.check(code, "bigbird_train_fwd")
    bigbird_train_fwd.launches += 1
    if buffers is not None:
        buffers["qkv"] = qkv_buf
    return out


def bigbird_ds_elements(B: int, nh: int, L: int, block_size: int, G: int, R: int) -> int:
    """bf16 elements of the dS tiles that the bf16 backward's dk/dv pass
    writes once for its dq pass: a (64, 64) tile for each key tile that a
    64-row query tile visits, ceil(L / 64) for the global rows' query tiles
    and (3 + G + R) S for the others (csrc/train_bigbird.cu
    bigbird_ds_tile)."""
    S, nb = -(-block_size // 64), L // block_size
    return B * nh * (G * S * -(-L // 64) + (nb - G) * S * (3 + G + R) * S) * 64 * 64


def bigbird_train_bwd(hidden, mask, seed, w, g, tables, *, num_heads: int, block_size: int,
                      sm_scale: float, dropout_rate: float, buffers: dict = None):
    """Backward kernel: recomputes the forward from its inputs and returns
    (dx in the compute dtype, dWqkv (H, 3 Hn), dbqkv (3 Hn,), dWo (Hn, H),
    dbo (H,) in float32, summed over the batch). A ``buffers`` dict receives
    the intermediates its products read: ctx and dctx (M, Hn), dproj = [dq
    dk dv] (M, 3 Hn) and w_all = Wqkv (H, 3 Hn); and those its gradient
    kernels read: qkv (3, B, nh, L, hd), the row statistics stats (3, B, nh,
    L) and counts (B, 2) (``bigbird_core_model_dproj``). In bf16 the dk/dv
    pass stores dS in a buffer of ``bigbird_ds_elements`` for the dq pass.
    ``bigbird_train_bwd.launches`` counts its launches."""
    B, L, H = hidden.shape
    HN = w["wo"].shape[0]
    hd = HN // num_heads
    dev, dt = hidden.device, hidden.dtype
    f32 = torch.float32
    empty = lambda *s, dtype=dt: torch.empty(s, dtype=dtype, device=dev)
    bufs = (empty(B, 2, dtype=torch.int32), empty(3, B, num_heads, L, hd), empty(B, L, HN),
            empty(B, L, HN), empty(3, B, num_heads, L, dtype=f32), empty(B * L, 3 * HN))
    ds = (empty(bigbird_ds_elements(B, num_heads, L, block_size, tables.G, tables.R))
          if dt == torch.bfloat16 else None)
    dx = torch.empty_like(hidden)
    dwqkv, dbqkv = empty(H, 3 * HN, dtype=f32), empty(3 * HN, dtype=f32)
    dwo, dbo = empty(HN, H, dtype=f32), empty(H, dtype=f32)
    splits, ws, floats = weight_grad_plan(dev, dt, B * L, (H, 3 * HN), (HN, H))
    with torch.cuda.device(dev):
        code = build.library().spk_bigbird_train_bwd(
            _DTYPES[dt], *(_ptr(t) for t in (hidden, mask, tables.rand, tables.rok,
                                              tables.inv_offsets, tables.inv_entries, seed,
                                              w["wqkv"], w["bqkv"], w["wo"], g, *bufs, ds, dx,
                                              dwqkv, dbqkv, dwo, dbo, ws)),
            floats, *splits, B, L, H, num_heads, hd, block_size, tables.G, tables.R,
            float(sm_scale), dropout_threshold(dropout_rate), 1.0 - dropout_rate, _stream(),
        )
    build.check(code, "bigbird_train_bwd")
    bigbird_train_bwd.launches += 1
    if buffers is not None:
        buffers.update(ctx=bufs[2].reshape(B * L, HN), dctx=bufs[3].reshape(B * L, HN),
                       dproj=bufs[5], w_all=w["wqkv"], qkv=bufs[1], stats=bufs[4],
                       counts=bufs[0])
    return dx, dwqkv, dbqkv, dwo, dbo


for _fn in (bigbird_train_fwd, bigbird_train_bwd):
    _fn.launches = 0


class _BigBirdTrain(torch.autograd.Function):
    """The kernels as one differentiable function of (hidden and the float32
    parameters); saves only the inputs and the seed."""

    @staticmethod
    def forward(ctx, hidden, mask, seed, qkv_kernel, qkv_bias, out_kernel, out_bias, tables,
                config):
        w = card_weights(qkv_kernel, qkv_bias, out_kernel, hidden.dtype)
        out = bigbird_train_fwd(hidden, mask, seed, w, out_bias.detach().float().contiguous(),
                                tables, **config)
        ctx.save_for_backward(hidden, mask, seed, *w.values())
        ctx.names, ctx.tables, ctx.config = list(w), tables, config
        return out

    @staticmethod
    def backward(ctx, g):
        hidden, mask, seed, *ws = ctx.saved_tensors
        w = dict(zip(ctx.names, ws))
        H = hidden.shape[-1]
        nh = ctx.config["num_heads"]
        hd = w["wo"].shape[0] // nh
        dx, dwqkv, dbqkv, dwo, dbo = bigbird_train_bwd(
            hidden, mask, seed, w, g.to(hidden.dtype).contiguous(), ctx.tables, **ctx.config)
        return (dx, None, None, dwqkv.reshape(H, 3, nh, hd), dbqkv.reshape(3, nh, hd),
                dwo.reshape(nh, hd, H), dbo, None, None)


def bigbird_attention_block_train(
    hidden: torch.Tensor,  # (B, L, H) compute dtype
    attention_mask: torch.Tensor,  # (B, L) int; suffix padding
    qkv_kernel: torch.Tensor,  # (H, 3, nh, hd) float32 parameter
    qkv_bias: torch.Tensor,  # (3, nh, hd)
    out_kernel: torch.Tensor,  # (nh, hd, H)
    out_bias: torch.Tensor,  # (H,)
    seed: torch.Tensor,  # (1,) int32: the dropout stream (ignored at rate 0)
    sm_scale: float,
    block_size: int,
    num_global_blocks: int,
    num_random_blocks: int,
    pattern_seed: int,
    dropout_rate: float = 0.0,
) -> torch.Tensor:
    """Differentiable BigBird attention block of the training path; returns
    (B, L, H) in hidden's dtype, before hidden-state dropout, residual and
    LayerNorm. The random pattern is ``bigbird_block_indices`` at
    ``pattern_seed``. A CUDA tensor that breaks the contract of
    ``ops/cuda/bigbird_block.py`` raises."""
    kw = dict(sm_scale=sm_scale, block_size=block_size, num_global_blocks=num_global_blocks,
              num_random_blocks=num_random_blocks, pattern_seed=pattern_seed,
              dropout_rate=dropout_rate)
    B, L, _ = hidden.shape
    if hidden.device.type == "cpu":
        keep = None
        if dropout_rate > 0.0:
            t = bigbird_tables(L // block_size, num_global_blocks, num_random_blocks,
                               pattern_seed, "cpu")
            keep = bigbird_keep_masks(seed, B, qkv_kernel.shape[2], L, block_size, t.G, t.R,
                                      dropout_rate)
        return bigbird_train_plain(hidden, attention_mask, qkv_kernel, qkv_bias, out_kernel,
                                   out_bias, keep=keep, **kw)
    where = "bigbird_attention_block_train"
    check_card_inputs(where, hidden, attention_mask, qkv_kernel, qkv_bias, out_kernel, out_bias,
                      block_size)
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"{where}: dropout_rate {dropout_rate} not in [0, 1)")
    tables = bigbird_tables(L // block_size, num_global_blocks, num_random_blocks, pattern_seed,
                            hidden.device)
    config = dict(num_heads=qkv_kernel.shape[2], block_size=block_size,
                  sm_scale=float(sm_scale), dropout_rate=float(dropout_rate))
    return _BigBirdTrain.apply(
        hidden.contiguous(), attention_mask.to(torch.int32).contiguous(),
        seed.to(torch.int32).contiguous(), qkv_kernel, qkv_bias, out_kernel, out_bias, tables,
        config)
