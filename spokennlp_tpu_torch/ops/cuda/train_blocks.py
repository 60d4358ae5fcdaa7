"""Training blocks with hand-written forward and backward kernels.

Counterpart of ``spokennlp_tpu/ops/pallas/train_blocks.py``:

- ``attention_block_train``: (dropout(softmax(q k^T sm_scale + mask)) v) Wo + bo
  for the training path, with dropout on the probabilities inside the
  kernels (``csrc/train_attention.cu``);
- ``mlp_block_train``: act(x W1 + b1) W2 + b2, "gelu" in its tanh form
  (``csrc/train_mlp.cu``).

Residual, LayerNorm and hidden-state dropout stay in PyTorch
(``models/encoder.py``). On a CUDA tensor each function runs its kernels
through a ``torch.autograd.Function`` whose backward is a kernel too, and the
forward saves only its inputs (and the dropout seed): the backward recomputes
the rest, as the TPU kernels do. On a CPU tensor it runs the plain float32
version beside it, whose gradient comes from autograd; the tests hold those
against the JAX kernels, and the kernels are held against them on the card.

Each backward kernel also has an explicit plain version
(``attention_train_bwd_plain``, ``mlp_train_bwd_plain``): the backward
written out step by step, every product through ``backward_product`` and
rounded where the kernels round. No model path runs it; the tests and the
card checks hold the kernels' products to it element by element, and plant
faults of a GEMM tile in ``backward_product``.

The attention kernels' cores (bf16, or float32 on 3xTF32) have rounding
models (``attention_rows_model``: the rows pass and its statistics;
``attention_core_bwd_model``: the gradient kernels' dq, dk, dv), dense over
a sequence's keys with float32 sums and no tiles, built from
``attention_models``, their products through its ``core_product`` hook;
``attention_rows`` and ``attention_grad`` launch those cores alone (no
model path calls them), and the card checks hold them to the models.

Dropout draws keep bits from Philox4x32-10 keyed by the seed, one per
(sequence, head, query row, key column), and keeps a probability iff its
bits are >= ``min(int(rate * 2**32), 2**32 - 1)``, as the TPU kernel
thresholds its hardware bits. ``philox_bits`` is the numpy twin of the
kernels' generator, so the plain version replays the kernels' mask exactly;
``dropout_keep_mask`` gives that mask on either device.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from spokennlp_tpu_torch.ops.cuda import attention_models as am
from spokennlp_tpu_torch.ops.cuda import build
from spokennlp_tpu_torch.ops.cuda.attention_block import _DTYPES, HEAD_DIMS, NEG_INF, _layer_norm
from spokennlp_tpu_torch.ops.cuda.int8_matmul import ACTIVATION_CODES, ACTIVATIONS, float_product

TRAIN_ACTIVATIONS = ("gelu", "gelu_new", "relu", "silu")  # those with a derivative


def dropout_threshold(rate: float) -> int:
    """keep iff bits >= thr, so P(keep) = 1 - rate (0 keeps everything)."""
    return min(int(rate * 2**32), 2**32 - 1) if rate > 0.0 else 0


# ------------------------------------------------------------------ Philox

_U32 = np.uint64(0xFFFFFFFF)
_PHILOX_M = (np.uint64(0xD2511F53), np.uint64(0xCD9E8D57))
_PHILOX_W = (np.uint64(0x9E3779B9), np.uint64(0xBB67AE85))


def philox_bits(seed: int, c0, c1, c2, c3) -> np.ndarray:
    """Philox4x32-10 on the counters (c0, c1, c2, c3) (broadcast together)
    under the key (seed, 0); the first output word, as uint32.

    The numpy twin of ``philox_bits`` in ``csrc/common.cuh``.
    """
    c = [np.asarray(v, np.uint64) for v in np.broadcast_arrays(c0, c1, c2, c3)]
    k0, k1 = np.uint64(seed & 0xFFFFFFFF), np.uint64(0)
    for r in range(10):
        if r:
            k0, k1 = (k0 + _PHILOX_W[0]) & _U32, (k1 + _PHILOX_W[1]) & _U32
        p0, p1 = _PHILOX_M[0] * c[0], _PHILOX_M[1] * c[2]  # < 2**64: exact
        c = [(p1 >> np.uint64(32)) ^ c[1] ^ k0, p1 & _U32, (p0 >> np.uint64(32)) ^ c[3] ^ k1,
             p0 & _U32]
    return c[0].astype(np.uint32)


def dropout_keep_mask(seed: torch.Tensor, B: int, nh: int, L: int, rate: float) -> torch.Tensor:
    """(B, nh, L, L) bool: where the attention kernels keep a probability for
    this (1,) int32 seed, on the seed's device (a kernel on the card, the
    numpy twin on the CPU)."""
    thr = dropout_threshold(rate)
    if seed.device.type == "cpu":
        b, h, r, c = np.ix_(np.arange(B), np.arange(nh), np.arange(L), np.arange(L))
        bits = philox_bits(int(seed.reshape(-1)[0]), b, h, r, c)
        return torch.from_numpy(bits >= np.uint32(thr))
    keep = torch.empty((B, nh, L, L), dtype=torch.uint8, device=seed.device)
    seed = seed.to(torch.int32).contiguous()
    with torch.cuda.device(seed.device):
        code = build.library().spk_dropout_mask(
            seed.data_ptr(), keep.data_ptr(), B, nh, L, thr,
            torch.cuda.current_stream().cuda_stream,
        )
    build.check(code, "dropout_keep_mask")
    return keep.bool()


# ------------------------------------------------------------ plain versions


def attention_train_plain(
    hidden: torch.Tensor,
    segment_ids: torch.Tensor,
    qkv_kernel: torch.Tensor,
    qkv_bias: torch.Tensor,
    out_kernel: torch.Tensor,
    out_bias: torch.Tensor,
    *,
    sm_scale: float,
    dropout_rate: float = 0.0,
    keep: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The training attention block in plain float32 PyTorch; returns
    hidden's dtype. ``keep`` (B, nh, L, L) bool is the dropout mask, needed
    when ``dropout_rate`` > 0: kept probabilities are scaled by
    1 / (1 - rate). Masked keys get an additive -1e9, as in the kernels.
    Both products go through ``float_product``."""
    B, L, H = hidden.shape
    qkv = float_product(hidden, qkv_kernel.reshape(H, -1)).reshape(B, L, *qkv_kernel.shape[1:])
    q, k, v = (qkv + qkv_bias.float()).unbind(2)  # (B, L, nh, hd)
    ctx = _attention_core_train(q, k, v, segment_ids, sm_scale, dropout_rate, keep)
    out = float_product(ctx.reshape(B, L, -1), out_kernel.reshape(-1, H)) + out_bias.float()
    return out.to(hidden.dtype)


def _attention_core_train(q, k, v, segment_ids, sm_scale, dropout_rate, keep):
    """ctx (B, L, nh, hd) of q, k, v (B, L, nh, hd) float32: the training
    core of ``attention_train_plain``, its two products through
    ``attention_models.core_product``."""
    heads = lambda t: t.transpose(1, 2)  # (B, nh, L, hd)
    scores = am.core_product(heads(q), heads(k).transpose(-1, -2)) * sm_scale
    seg = segment_ids
    allowed = (seg[:, :, None] == seg[:, None, :]) & (seg[:, None, :] > 0)
    scores = scores + torch.where(allowed, 0.0, NEG_INF)[:, None]
    probs = torch.softmax(scores, dim=-1)
    if dropout_rate > 0.0:
        if keep is None:
            raise ValueError("attention_train_plain: dropout_rate > 0 needs the keep mask")
        probs = torch.where(keep, probs / (1.0 - dropout_rate), 0.0)
    return am.core_product(probs, heads(v)).transpose(1, 2)


def mlp_train_plain(x, w1, b1, w2, b2, *, activation: str) -> torch.Tensor:
    """act(x W1 + b1) W2 + b2 in plain float32 PyTorch, both products
    through ``float_product``; returns x's dtype."""
    h = ACTIVATIONS[activation](float_product(x, w1) + b1.float())
    return (float_product(h, w2) + b2.float()).to(x.dtype)


# ------------------------------------------------------- explicit backwards


def backward_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., K) . (K, N) in float32: every product of the explicit plain
    backwards (the planted faults of their bf16 and float32 card limits
    replace it)."""
    return a.float() @ b.float()


def weight_grad_plain(x: torch.Tensor, dy: torch.Tensor):
    """(dW = x^T dy, db = the column sums of dy), float32, of x (M, Hin) and
    dy (M, N): the weight gradient of ``weight_grad``."""
    return backward_product(x.t(), dy), dy.float().sum(0)


def out_grad_plain(g: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """dctx = g Wo^T rounded to g's dtype, of g (M, H) and wo (Hn, H): the
    first product of an attention block's backward."""
    return backward_product(g, wo.t()).to(g.dtype)


def projection_grads_plain(x, g, ctx, dproj, w_all, wo):
    """The products that close a training attention block's backward, of x
    (M, H), g (M, H), ctx (M, Hn) and the projections' gradient dproj (M,
    ld) in the compute dtype, and the weights w_all (H, ld) and wo (Hn, H):
    (dx = dproj W_all^T rounded to x's dtype, dW_all, db_all, dWo, dbo in
    float32, summed over the rows)."""
    dx = backward_product(dproj, w_all.t()).to(x.dtype)
    return (dx, *weight_grad_plain(x, dproj), *weight_grad_plain(ctx, g))


def activation_and_grad_plain(pre: torch.Tensor, activation: str):
    """(act(pre), act'(pre)) in float32, the derivative by autograd of the
    ``ACTIVATIONS`` form (tanh GELU for "gelu", as the kernels take it)."""
    with torch.enable_grad():
        p = pre.detach().float().requires_grad_()
        h = ACTIVATIONS[activation](p)
        (dh,) = torch.autograd.grad(h.sum(), p)
    return h.detach(), dh


def mlp_train_bwd_plain(x, w1, b1, w2, g, *, activation: str):
    """The MLP kernels' backward written out: pre = x W1 + b1, h = act(pre)
    rounded to x's dtype and act'(pre) in float32, dpre = (g W2^T) act'
    rounded, dx = dpre W1^T rounded, dW1 = x^T dpre, dW2 = h^T g and the bias
    gradients in float32. Returns (dx, dW1, db1, dW2, db2) as
    ``mlp_train_bwd`` does; in float32 it is autograd of ``mlp_train_plain``."""
    dt = x.dtype
    h, dh = activation_and_grad_plain(backward_product(x, w1) + b1.float(), activation)
    dpre = (backward_product(g, w2.t()) * dh).to(dt)
    dx = backward_product(dpre, w1.t()).to(dt)
    return (dx, *weight_grad_plain(x, dpre), *weight_grad_plain(h.to(dt), g))


def attention_train_bwd_plain(hidden, segment_ids, qkv_kernel, qkv_bias, out_kernel, g, *,
                              sm_scale: float, dropout_rate: float = 0.0, keep=None):
    """The attention kernels' backward written out: the projections
    recomputed and rounded to hidden's dtype, dctx = g Wo^T rounded, the
    core's gradient (autograd of the plain core in float32) rounded, then
    ``projection_grads_plain`` on the rounded ctx. Returns (dx, dWqkv (H, 3
    Hn), dbqkv, dWo (Hn, H), dbo) as ``attention_train_bwd`` does; in
    float32 it is autograd of ``attention_train_plain``."""
    B, L, H = hidden.shape
    _, _, nh, hd = qkv_kernel.shape
    dt, M = hidden.dtype, B * L
    x, g2 = hidden.reshape(M, H), g.reshape(M, H)
    wqkv, wo = qkv_kernel.reshape(H, 3 * nh * hd), out_kernel.reshape(nh * hd, H)
    qkv = (backward_product(x, wqkv) + qkv_bias.float().reshape(-1)).to(dt).float()
    with torch.enable_grad():
        qkv = qkv.requires_grad_()
        q, k, v = qkv.reshape(B, L, 3, nh, hd).unbind(2)
        ctx = _attention_core_train(q, k, v, segment_ids, sm_scale, dropout_rate, keep)
        ctx = ctx.reshape(M, nh * hd)
        (dqkv,) = torch.autograd.grad(ctx, qkv, out_grad_plain(g2, wo).float())
    dx, *grads = projection_grads_plain(x, g2, ctx.detach().to(dt), dqkv.to(dt), wqkv, wo)
    return (dx.reshape(B, L, H), *grads)


# ------------------------------------------------ the cores' rounding models


def dense_model_scores(q, k, segment_ids, sm_scale: float) -> torch.Tensor:
    """The dense kernels' scores (B, nh, L, L) float32 of q, k (B, nh, L, hd):
    q k^T sm_scale, plus -1e9 where the key is masked (its segment id differs
    from the row's, or is 0), as the TPU kernel adds it."""
    seg = segment_ids
    allowed = (seg[:, :, None] == seg[:, None, :]) & (seg[:, None, :] > 0)
    s = am.core_product(q, k.transpose(-1, -2)) * sm_scale
    return s + torch.where(allowed, 0.0, NEG_INF)[:, None]


def dense_model_allowed(L: int, device) -> torch.Tensor:
    """(L, L) bool: the keys the dense kernels run a row over, every key of
    the sequence (the segment mask is in the scores; a planted fault of the
    card gate replaces it)."""
    return torch.ones(L, L, dtype=torch.bool, device=device)


def attention_rows_model(q, k, v, segment_ids, *, sm_scale: float, dctx=None,
                         dropout_rate: float = 0.0, keep=None):
    """The rounding model of attn_rows_kernel from the kernels' own q
    (unscaled), k, v (B, nh, L, hd), the segment ids (B, L) and the keep
    mask of ``dropout_keep_mask`` (None at rate 0); with ``dctx`` (B, L, nh,
    hd) also rowsum(dp p_eff). Dense over a sequence's keys with float32
    sums and no tiles; e rounded where the kernel rounds it
    (``attention_models.rows_exponent``, against the row's true maximum).
    Returns ctx (B, L, nh, hd) in q's dtype and the row statistics (3, B,
    nh, L) float32 = (m, D, rowsum(dp p_eff)) (rs zero without dctx)."""
    dt, L = q.dtype, q.shape[2]
    s = dense_model_scores(q, k, segment_ids, sm_scale)
    dp = None if dctx is None else am.core_product(dctx.transpose(1, 2), v.transpose(-1, -2))
    ctx, m, D, rs = am.rows_attend(s, v.float(), dense_model_allowed(L, q.device), keep, dt,
                                   1.0 - dropout_rate, dp)
    stats = torch.stack([m, D, torch.zeros_like(D) if rs is None else rs])
    return ctx.transpose(1, 2).to(dt), stats


def attention_core_bwd_model(q, k, v, dctx, segment_ids, *, sm_scale: float, stats=None,
                             dropout_rate: float = 0.0, keep=None):
    """The rounding model of the dense backward's gradient kernels
    (attn_dkv_kernel, attn_dq_kernel), from the kernels' own q (unscaled),
    k, v (B, nh, L, hd), dctx (B, L, nh, hd), the segment ids, the row
    statistics stats (3, B, nh, L) (None: taken here) and the keep mask.
    Dense with float32 sums and no tiles; dS = round((p_eff dp - p rs)
    sm_scale) (``attention_models.dense_core_grad``), dq, dk and dv rounded
    once. Returns (dq, dk, dv), each (B, L, nh, hd) in q's dtype."""
    dt, L = q.dtype, q.shape[2]
    s = dense_model_scores(q, k, segment_ids, sm_scale)
    dc = dctx.float().transpose(1, 2)  # (B, nh, L, hd)
    tr = lambda t: t.transpose(-1, -2)
    ds, pe = am.dense_core_grad(s, am.core_product(dc, tr(v)), dense_model_allowed(L, q.device),
                                keep, stats, dt, 1.0 - dropout_rate, scale=sm_scale)
    mm = am.core_product
    grads = (mm(ds, k), mm(tr(ds), q), mm(tr(pe), dc))
    return tuple(am.rounded(t, dt).transpose(1, 2).to(dt) for t in grads)


def attention_core_model_dproj(buffers: dict, *, sm_scale: float, dropout_rate: float = 0.0,
                               keep=None) -> torch.Tensor:
    """The model's [dq dk dv] (B*L, 3 Hn) on the intermediates that
    ``attention_train_bwd`` put into ``buffers``: the layout of the kernel's
    dproj."""
    qkv = buffers["qkv"]
    B, nh, L, hd = qkv.shape[1:]
    grads = attention_core_bwd_model(
        qkv[0], qkv[1], qkv[2], buffers["dctx"].reshape(B, L, nh, hd), buffers["seg"],
        sm_scale=sm_scale, stats=buffers["stats"], dropout_rate=dropout_rate, keep=keep)
    return torch.stack(grads, dim=2).reshape(B * L, -1)


# ------------------------------------------------------------ kernel calls


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


# The weight gradients split their rows into ranges (launch_weight_grad,
# csrc/bf16_gemm.cuh; bf16 on its tensor-core tile, float32 on the 3xTF32
# tile of csrc/tf32x3_gemm.cuh): each block of 128 x 128 output tiles walks
# one range, two blocks an SM, and the ranges' partial sums are added in
# order after. weight_grad_splits takes the count that fills the SMs best:
# the fewest waves of blocks per share of the work, each range at least
# WGRAD_MIN_STAGES stages of 32 rows, at most WGRAD_MAX_SPLITS ranges; in
# bf16 it leaves a gradient of at least 1.5 tiles an SM whole (on the H100,
# 216 tiles ran fastest unsplit: most SMs already hold two blocks, and blocks
# at one k-range share their operands in L2), while the 3xTF32 tile, three
# times the tensor-core work a product, gains from the split there too
# (PERF.md gives the measurements the rule was chosen by).
WGRAD_TILE, WGRAD_BLOCKS_PER_SM, WGRAD_MIN_STAGES, WGRAD_MAX_SPLITS = 128, 2, 16, 8


def weight_grad_splits(M: int, Hin: int, N: int, sms: int, dtype=torch.bfloat16) -> int:
    """The row ranges of a weight gradient (Hin, N) over M rows in ``dtype``
    on a card of ``sms`` SMs."""
    tiles = -(-Hin // WGRAD_TILE) * -(-N // WGRAD_TILE)
    if dtype == torch.bfloat16 and 2 * tiles >= 3 * sms:
        return 1
    slots, stages = WGRAD_BLOCKS_PER_SM * sms, -(-M // 32)
    best, cost = 1, float(-(-tiles // slots))
    for s in range(2, WGRAD_MAX_SPLITS + 1):
        if stages < s * WGRAD_MIN_STAGES:
            break
        c = -(-tiles * s // slots) / s  # waves of blocks, each a 1/s share of the rows
        if c < cost:
            best, cost = s, c
    return best


def weight_grad_workspace(splits: int, Hin: int, N: int) -> int:
    """float32 elements of the workspace of a weight gradient over
    ``splits`` row ranges: each range's partial dW and db, padded to
    multiples of 4 (csrc/bf16_gemm.cuh weight_grad_workspace_floats)."""
    pad4 = lambda n: -(-n // 4) * 4
    return splits * (pad4(Hin * N) + pad4(N)) if splits > 1 else 0


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def weight_grad_layout(dtype, M: int, shapes, sms: int):
    """(splits of each weight gradient (Hin, N) of ``shapes`` over M rows in
    ``dtype`` on a card of ``sms`` SMs, float32 elements of the workspace
    they share, one after another on the stream)."""
    splits = [weight_grad_splits(M, hin, n, sms, dtype) for hin, n in shapes]
    return splits, max(weight_grad_workspace(s, hin, n) for s, (hin, n) in zip(splits, shapes))


def weight_grad_plan(device, dtype, M: int, *shapes):
    """(splits of each weight gradient (Hin, N) over M rows in ``dtype``,
    their float32 workspace from the allocator (None when none splits), its
    length) on ``device``'s card."""
    sms = _sm_count(device.index if device.index is not None else torch.cuda.current_device())
    splits, floats = weight_grad_layout(dtype, M, shapes, sms)
    ws = torch.empty(floats, dtype=torch.float32, device=device) if floats else None
    return splits, ws, floats


def _ptr(t) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _check_card_tensor(name: str, t: torch.Tensor, device, shape, dtype=None):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {tuple(shape)}, got {tuple(t.shape)}")
    if dtype is not None and t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def attention_train_fwd(hidden, seg, seed, wqkv, bqkv, wo, bo, *, num_heads: int,
                        sm_scale: float, dropout_rate: float,
                        buffers: Optional[dict] = None) -> torch.Tensor:
    """Forward kernel: hidden (B, L, H) and the weights wqkv (H, 3 Hn), wo
    (Hn, H) in the compute dtype, biases bqkv (3 Hn,), bo (H,) float32, seg
    (B, L) and seed (1,) int32, all on one card. A ``buffers`` dict receives
    the projections qkv (3, B, nh, L, hd) and ctx (B, L, Hn).
    ``attention_train_fwd.launches`` counts its launches."""
    B, L, H = hidden.shape
    HN = wo.shape[0]
    hd = HN // num_heads
    dev, dt = hidden.device, hidden.dtype
    qkv_buf = torch.empty((3, B, num_heads, L, hd), dtype=dt, device=dev)
    ctx_buf = torch.empty((B, L, HN), dtype=dt, device=dev)
    out = torch.empty_like(hidden)
    with torch.cuda.device(dev):
        code = build.library().spk_attention_train_fwd(
            _DTYPES[dt], hidden.data_ptr(), seg.data_ptr(), seed.data_ptr(), wqkv.data_ptr(),
            bqkv.data_ptr(), wo.data_ptr(), bo.data_ptr(), qkv_buf.data_ptr(),
            ctx_buf.data_ptr(), out.data_ptr(), B, L, H, num_heads, hd, float(sm_scale),
            dropout_threshold(dropout_rate), 1.0 - dropout_rate, _stream(),
        )
    build.check(code, "attention_train_fwd")
    attention_train_fwd.launches += 1
    if buffers is not None:
        buffers.update(qkv=qkv_buf, ctx=ctx_buf)
    return out


def attention_train_bwd(hidden, seg, seed, wqkv, bqkv, wo, g, *, num_heads: int,
                        sm_scale: float, dropout_rate: float, buffers: Optional[dict] = None):
    """Backward kernel: recomputes the forward from its inputs and returns
    (dx in the compute dtype, dWqkv (H, 3 Hn), dbqkv (3 Hn,), dWo (Hn, H),
    dbo (H,) in float32, summed over the batch). A ``buffers`` dict receives
    the intermediates its products read: ctx and dctx (M, Hn), dproj = [dq
    dk dv] (M, 3 Hn) and w_all = Wqkv (H, 3 Hn). ``attention_train_bwd.
    launches`` counts its launches."""
    B, L, H = hidden.shape
    HN = wo.shape[0]
    hd = HN // num_heads
    dev, dt = hidden.device, hidden.dtype
    empty = lambda *s, dtype=dt: torch.empty(s, dtype=dtype, device=dev)
    qkv_buf, dctx_buf, ctx_buf = empty(3, B, num_heads, L, hd), empty(B, L, HN), empty(B, L, HN)
    stats, dqkv = empty(3, B, num_heads, L, dtype=torch.float32), empty(B, L, 3 * HN)
    ds_buf = empty(dense_ds_elements(B, num_heads, L))
    dx = torch.empty_like(hidden)
    f32 = torch.float32
    dwqkv, dbqkv = empty(H, 3 * HN, dtype=f32), empty(3 * HN, dtype=f32)
    dwo, dbo = empty(HN, H, dtype=f32), empty(H, dtype=f32)
    splits, ws, floats = weight_grad_plan(dev, dt, B * L, (H, 3 * HN), (HN, H))
    ptrs = [_ptr(t) for t in (hidden, seg, seed, wqkv, bqkv, wo, g, qkv_buf, dctx_buf, ctx_buf,
                              stats, dqkv, ds_buf, dx, dwqkv, dbqkv, dwo, dbo, ws)]
    with torch.cuda.device(dev):
        code = build.library().spk_attention_train_bwd(
            _DTYPES[dt], *ptrs, floats, *splits, B, L, H, num_heads, hd, float(sm_scale),
            dropout_threshold(dropout_rate), 1.0 - dropout_rate, _stream(),
        )
    build.check(code, "attention_train_bwd")
    attention_train_bwd.launches += 1
    if buffers is not None:
        buffers.update(ctx=ctx_buf.reshape(B * L, HN), dctx=dctx_buf.reshape(B * L, HN),
                       dproj=dqkv.reshape(B * L, 3 * HN), w_all=wqkv, qkv=qkv_buf, stats=stats,
                       seg=seg)
    return dx, dwqkv, dbqkv, dwo, dbo


def dense_ds_elements(B: int, nh: int, L: int) -> int:
    """Elements of the backward's dS buffer, in the compute dtype: a (64
    keys, 64 rows) tile for each (query tile, key tile) of each (sequence,
    head) (csrc/train_attention.cu dense_ds_tile)."""
    nt = -(-L // 64)
    return B * nh * nt * nt * 64 * 64


def attention_rows(qkv, seg, seed, *, sm_scale: float, dctx=None, dropout_rate: float = 0.0):
    """attn_rows_kernel alone: qkv (3, B, nh, L, hd) with q unscaled, seg (B,
    L) and seed (1,) int32 and, for the statistics pass, dctx (B, L, nh hd).
    Returns ctx (B, L, nh, hd) in qkv's dtype and, with dctx, the row
    statistics (3, B, nh, L) float32 (else None). On the CPU it runs
    ``attention_rows_model``; on the card the kernel, whose launches
    ``attention_rows.launches`` counts. No model path calls it: the blocks
    launch the kernel inside their own entries."""
    _, B, nh, L, hd = qkv.shape
    if qkv.device.type == "cpu":
        keep = dropout_keep_mask(seed, B, nh, L, dropout_rate) if dropout_rate > 0.0 else None
        ctx, stats = attention_rows_model(
            qkv[0], qkv[1], qkv[2], seg, sm_scale=sm_scale, dropout_rate=dropout_rate, keep=keep,
            dctx=None if dctx is None else dctx.reshape(B, L, nh, hd))
        return ctx, None if dctx is None else stats
    if qkv.device.type != "cuda":
        raise ValueError(f"attention_rows: unsupported device {qkv.device}")
    ctx = torch.empty(B, L, nh, hd, dtype=qkv.dtype, device=qkv.device)
    stats = None if dctx is None else torch.empty(3, B, nh, L, device=qkv.device)
    with torch.cuda.device(qkv.device):
        code = build.library().spk_attention_rows(
            _DTYPES[qkv.dtype], int(dctx is not None), _ptr(qkv), _ptr(seg), _ptr(seed),
            _ptr(dctx), _ptr(ctx), _ptr(stats), B, L, nh, hd, float(sm_scale),
            dropout_threshold(dropout_rate), 1.0 - dropout_rate, _stream())
    build.check(code, "attention_rows")
    attention_rows.launches += 1
    return ctx, stats


def attention_grad(qkv, seg, seed, dctx, stats, *, sm_scale: float, dropout_rate: float = 0.0,
                   which: int = 3, out=None):
    """The backward's gradient kernels alone, after ``attention_rows`` with
    dctx: which = 1 runs attn_dkv_kernel (dk, dv and every dS tile), 2
    attn_dq_kernel (dq, from the dS tiles of an earlier call with the same
    ``out``), 3 both. qkv (3, B, nh, L, hd), seg (B, L),
    seed (1,), dctx (B, L, nh hd), stats (3, B, nh, L). ``out`` = (dqkv,
    ds_buf) of an earlier call to write into, or None. Returns (dqkv (B*L,
    3 nh hd), ds_buf (the dS tiles in qkv's dtype)). On the CPU it runs
    ``attention_core_bwd_model`` (all three slots); on the card the
    kernels, whose launches ``attention_grad.launches`` counts. No model
    path calls it."""
    _, B, nh, L, hd = qkv.shape
    if qkv.device.type == "cpu":
        keep = dropout_keep_mask(seed, B, nh, L, dropout_rate) if dropout_rate > 0.0 else None
        grads = attention_core_bwd_model(qkv[0], qkv[1], qkv[2], dctx.reshape(B, L, nh, hd), seg,
                                         sm_scale=sm_scale, stats=stats,
                                         dropout_rate=dropout_rate, keep=keep)
        return torch.stack(grads, dim=2).reshape(B * L, -1), None
    if qkv.device.type != "cuda":
        raise ValueError(f"attention_grad: unsupported device {qkv.device}")
    dt, dev = qkv.dtype, qkv.device
    if out is None:
        out = (torch.empty(B * L, 3 * nh * hd, dtype=dt, device=dev),
               torch.empty(dense_ds_elements(B, nh, L), dtype=dt, device=dev))
    dqkv, ds_buf = out
    with torch.cuda.device(dev):
        code = build.library().spk_attention_grad(
            _DTYPES[dt], which, _ptr(qkv), _ptr(seg), _ptr(seed), _ptr(dctx), _ptr(stats),
            _ptr(ds_buf), _ptr(dqkv), B, L, nh, hd, float(sm_scale),
            dropout_threshold(dropout_rate), 1.0 - dropout_rate, _stream())
    build.check(code, "attention_grad")
    attention_grad.launches += 1
    return dqkv, ds_buf


def mlp_train_fwd(x, w1, b1, w2, b2, *, activation: str,
                  buffers: Optional[dict] = None) -> torch.Tensor:
    """Forward kernel: x (M, H), w1 (H, I), w2 (I, H) in the compute dtype,
    b1, b2 float32. A ``buffers`` dict receives the intermediate h = act(x
    W1 + b1) (M, I). ``mlp_train_fwd.launches`` counts its launches."""
    M, H = x.shape
    I = w1.shape[1]
    h_buf = torch.empty((M, I), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        code = build.library().spk_mlp_train_fwd(
            _DTYPES[x.dtype], x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            b2.data_ptr(), h_buf.data_ptr(), out.data_ptr(), M, H, I,
            ACTIVATION_CODES[activation], _stream(),
        )
    build.check(code, "mlp_train_fwd")
    mlp_train_fwd.launches += 1
    if buffers is not None:
        buffers["h"] = h_buf
    return out


def mlp_train_bwd(x, w1, b1, w2, g, *, activation: str, buffers: Optional[dict] = None):
    """Backward kernel: recomputes the intermediate and returns (dx in the
    compute dtype, dW1, db1, dW2, db2 in float32, summed over the rows). A
    ``buffers`` dict receives the recomputed h (M, I).
    ``mlp_train_bwd.launches`` counts its launches."""
    M, H = x.shape
    I = w1.shape[1]
    dev, dt = x.device, x.dtype
    f32 = torch.float32
    h_buf = torch.empty((M, I), dtype=dt, device=dev)
    hgrad_buf = torch.empty((M, I), dtype=f32, device=dev)
    dpre_buf = torch.empty((M, I), dtype=dt, device=dev)
    dx = torch.empty_like(x)
    dw1, db1 = torch.empty((H, I), dtype=f32, device=dev), torch.empty(I, dtype=f32, device=dev)
    dw2, db2 = torch.empty((I, H), dtype=f32, device=dev), torch.empty(H, dtype=f32, device=dev)
    (splits, _), ws, floats = weight_grad_plan(dev, dt, M, (H, I), (I, H))
    ptrs = [_ptr(t) for t in (x, w1, b1, w2, g, h_buf, hgrad_buf, dpre_buf, dx, dw1, db1, dw2,
                              db2, ws)]
    with torch.cuda.device(dev):
        code = build.library().spk_mlp_train_bwd(
            _DTYPES[dt], *ptrs, floats, splits, M, H, I, ACTIVATION_CODES[activation], _stream(),
        )
    build.check(code, "mlp_train_bwd")
    mlp_train_bwd.launches += 1
    if buffers is not None:
        buffers["h"] = h_buf
    return dx, dw1, db1, dw2, db2


def weight_grad(x: torch.Tensor, dy: torch.Tensor, splits: Optional[int] = None):
    """The training backwards' weight gradient alone: (dW = x^T dy (Hin, N),
    db (N,)) in float32 of x (M, Hin) and dy (M, N) in one compute dtype,
    over ``splits`` row ranges (``weight_grad_splits``' count by default).
    No model path calls it: it holds and times the weight-gradient tiles
    alone. On a CPU tensor it runs ``weight_grad_plain``.
    ``weight_grad.launches`` counts its launches."""
    if x.dim() != 2 or dy.dim() != 2 or x.shape[0] != dy.shape[0]:
        raise ValueError(f"weight_grad: x (M, Hin) and dy (M, N), got {tuple(x.shape)} and "
                         f"{tuple(dy.shape)}")
    if x.device.type == "cpu":
        return weight_grad_plain(x, dy)
    (M, Hin), N = x.shape, dy.shape[1]
    _check_card_tensor("weight_grad: dy", dy.contiguous(), x.device, (M, N), x.dtype)
    if x.dtype not in _DTYPES:
        raise TypeError(f"weight_grad: x must be float32 or bfloat16, got {x.dtype}")
    dev, f32 = x.device, torch.float32
    x, dy = x.contiguous(), dy.contiguous()
    if splits is None:
        (splits,), ws, floats = weight_grad_plan(dev, x.dtype, M, (Hin, N))
    else:
        floats = weight_grad_workspace(int(splits), Hin, N)
        ws = torch.empty(floats, dtype=f32, device=dev) if floats else None
    dw, db = torch.empty((Hin, N), dtype=f32, device=dev), torch.empty(N, dtype=f32, device=dev)
    with torch.cuda.device(dev):
        code = build.library().spk_weight_grad(
            _DTYPES[x.dtype], x.data_ptr(), dy.data_ptr(), dw.data_ptr(), db.data_ptr(), _ptr(ws),
            floats, int(splits), M, Hin, N, _stream())
    build.check(code, "weight_grad")
    weight_grad.launches += 1
    return dw, db


# forward_tile's kernels: the C entry's `which`
_TILE_KERNELS = {"gemm": 0, "residual_ln": 1, "qkv": 2, "gemm_t": 3}


def forward_tile(a, w, bias=None, *, kernel: str = "gemm", gate=None, resid=None, ln=None,
                 heads=None, sm_scale: float = 1.0, activation: str = "none",
                 eps: float = 1e-12):
    """One GEMM tile kernel of csrc/bf16_gemm.cuh alone, on the tile of a's
    dtype (bf16's, or the 3xTF32 one in float32), a (M, K) and w in one
    compute dtype, bias (N,) float32 or None (zeros). ``kernel``:

    - "gemm": act(a w + bias) * gate of w (K, N), gate (M, N) float32 or None
      (gemm_bias_act_kernel);
    - "gemm_t": the same of w (N, K) read transposed, the training
      backwards' products (gemm_bias_act_kernel<T, true>);
    - "residual_ln": LayerNorm(resid + a w + bias) of resid (M, N) and ``ln``
      = (ln_scale, ln_bias), or a w + bias when both are None
      (gemm_bias_residual_ln_kernel);
    - "qkv": the q/k/v projection (3, 1, heads, M, N / (3 heads)) of a w +
      bias, q scaled by ``sm_scale`` (qkv_proj_kernel).

    No model path calls it: it holds the tiles alone. On a CPU tensor it
    runs the same arithmetic with ``float_product``;
    ``forward_tile.launches`` counts its launches."""
    if kernel not in _TILE_KERNELS:
        raise ValueError(f"forward_tile: kernel {kernel!r} is none of {sorted(_TILE_KERNELS)}")
    if (resid is None) != (ln is None) or (resid is not None and kernel != "residual_ln"):
        raise ValueError("forward_tile: resid and ln go together, with kernel='residual_ln'")
    if gate is not None and kernel not in ("gemm", "gemm_t"):
        raise ValueError(f"forward_tile: kernel {kernel!r} takes no gate")
    wk = w.t() if kernel == "gemm_t" and w.dim() == 2 else w  # (K, N)
    if a.dim() != 2 or w.dim() != 2 or a.shape[1] != wk.shape[0]:
        raise ValueError(f"forward_tile: a (M, K) and w ({'N, K' if kernel == 'gemm_t' else 'K, N'}"
                         f"), got {tuple(a.shape)} and {tuple(w.shape)}")
    (M, K), N = a.shape, wk.shape[1]
    if kernel == "qkv" and (not heads or N % (3 * heads)):
        raise ValueError(f"forward_tile: N = {N} is no 3 x heads x head_dim")
    if bias is None:
        bias = torch.zeros(N, dtype=torch.float32, device=a.device)
    if a.device.type == "cpu":
        y = float_product(a, wk) + bias.float()
        if kernel in ("gemm", "gemm_t"):
            y = ACTIVATIONS[activation](y)
            y = y if gate is None else y * gate.float()
        elif kernel == "residual_ln" and ln is not None:
            y = _layer_norm(y + resid.float(), *ln, eps)
        elif kernel == "qkv":
            y[:, :N // 3] *= sm_scale
            y = y.reshape(M, 3, heads, N // (3 * heads)).permute(1, 2, 0, 3)[:, None]
        return y.to(a.dtype).contiguous()
    if a.device.type != "cuda":
        raise ValueError(f"forward_tile: unsupported device {a.device}")
    if a.dtype not in _DTYPES:
        raise TypeError(f"forward_tile: a must be float32 or bfloat16, got {a.dtype}")
    a = a.contiguous()
    _check_card_tensor("forward_tile: w", w, a.device, tuple(w.shape), a.dtype)
    _check_card_tensor("forward_tile: bias", bias, a.device, (N,), torch.float32)
    if gate is not None:
        _check_card_tensor("forward_tile: gate", gate, a.device, (M, N), torch.float32)
    if resid is not None:
        _check_card_tensor("forward_tile: resid", resid, a.device, (M, N), a.dtype)
        for t in ln:
            _check_card_tensor("forward_tile: ln", t, a.device, (N,), torch.float32)
    shape = (3, 1, heads, M, N // (3 * heads)) if kernel == "qkv" else (M, N)
    out = torch.empty(shape, dtype=a.dtype, device=a.device)
    rows = (torch.empty((M, N), dtype=torch.float32, device=a.device)
            if kernel == "residual_ln" else None)
    lns, lnb = ln if ln is not None else (None, None)
    with torch.cuda.device(a.device):
        code = build.library().spk_forward_tile(
            _DTYPES[a.dtype], _TILE_KERNELS[kernel], a.data_ptr(), w.data_ptr(), bias.data_ptr(),
            _ptr(gate), _ptr(resid), _ptr(lns), _ptr(lnb), _ptr(rows), out.data_ptr(), M, N, K,
            ACTIVATION_CODES[activation], heads or 0, float(sm_scale), float(eps), _stream())
    build.check(code, "forward_tile")
    forward_tile.launches += 1
    return out


for _fn in (attention_train_fwd, attention_train_bwd, mlp_train_fwd, mlp_train_bwd, weight_grad,
            forward_tile, attention_rows, attention_grad):
    _fn.launches = 0


class _AttentionTrain(torch.autograd.Function):
    """The attention kernels as one differentiable function of (hidden and
    the float32 parameters); saves only the inputs and the seed."""

    @staticmethod
    def forward(ctx, hidden, seg, seed, qkv_kernel, qkv_bias, out_kernel, out_bias, sm_scale,
                rate):
        H, _, nh, hd = qkv_kernel.shape
        dt = hidden.dtype
        wqkv = qkv_kernel.detach().to(dt).reshape(H, 3 * nh * hd).contiguous()
        bqkv = qkv_bias.detach().float().reshape(-1).contiguous()
        wo = out_kernel.detach().to(dt).reshape(nh * hd, H).contiguous()
        bo = out_bias.detach().float().contiguous()
        out = attention_train_fwd(hidden, seg, seed, wqkv, bqkv, wo, bo, num_heads=nh,
                                  sm_scale=sm_scale, dropout_rate=rate)
        ctx.save_for_backward(hidden, seg, seed, wqkv, bqkv, wo)
        ctx.config = (nh, hd, sm_scale, rate)
        return out

    @staticmethod
    def backward(ctx, g):
        hidden, seg, seed, wqkv, bqkv, wo = ctx.saved_tensors
        nh, hd, sm_scale, rate = ctx.config
        H = hidden.shape[-1]
        dx, dwqkv, dbqkv, dwo, dbo = attention_train_bwd(
            hidden, seg, seed, wqkv, bqkv, wo, g.to(hidden.dtype).contiguous(), num_heads=nh,
            sm_scale=sm_scale, dropout_rate=rate,
        )
        return (dx, None, None, dwqkv.reshape(H, 3, nh, hd), dbqkv.reshape(3, nh, hd),
                dwo.reshape(nh, hd, H), dbo, None, None)


class _MlpTrain(torch.autograd.Function):
    """The MLP kernels as one differentiable function of (x and the float32
    parameters); saves only the inputs."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, activation):
        dt = x.dtype
        w1c, w2c = w1.detach().to(dt).contiguous(), w2.detach().to(dt).contiguous()
        b1c, b2c = b1.detach().float().contiguous(), b2.detach().float().contiguous()
        out = mlp_train_fwd(x, w1c, b1c, w2c, b2c, activation=activation)
        ctx.save_for_backward(x, w1c, b1c, w2c)
        ctx.activation = activation
        return out

    @staticmethod
    def backward(ctx, g):
        x, w1c, b1c, w2c = ctx.saved_tensors
        dx, dw1, db1, dw2, db2 = mlp_train_bwd(
            x, w1c, b1c, w2c, g.to(x.dtype).contiguous(), activation=ctx.activation
        )
        return dx, dw1, db1, dw2, db2, None


def attention_block_train(
    hidden: torch.Tensor,  # (B, L, H) compute dtype
    segment_ids: torch.Tensor,  # (B, L) int; 0 = padding
    qkv_kernel: torch.Tensor,  # (H, 3, nh, hd) float32 parameter
    qkv_bias: torch.Tensor,  # (3, nh, hd)
    out_kernel: torch.Tensor,  # (nh, hd, H)
    out_bias: torch.Tensor,  # (H,)
    seed: torch.Tensor,  # (1,) int32: the dropout stream (ignored at rate 0)
    *,
    sm_scale: float,
    dropout_rate: float = 0.0,
) -> torch.Tensor:
    """Differentiable attention block of the training path; returns (B, L, H)
    in hidden's dtype, before hidden-state dropout, residual and LayerNorm."""
    H, three, nh, hd = qkv_kernel.shape
    if three != 3:
        raise ValueError(f"attention_block_train: qkv_kernel must be (H, 3, nh, hd), got "
                         f"{tuple(qkv_kernel.shape)}")
    if hidden.device.type == "cpu":
        keep = None
        if dropout_rate > 0.0:
            B, L, _ = hidden.shape
            keep = dropout_keep_mask(seed, B, nh, L, dropout_rate)
        return attention_train_plain(
            hidden, segment_ids, qkv_kernel, qkv_bias, out_kernel, out_bias,
            sm_scale=sm_scale, dropout_rate=dropout_rate, keep=keep,
        )
    if hidden.device.type != "cuda":
        raise ValueError(f"attention_block_train: unsupported device {hidden.device}")
    if hidden.dtype not in _DTYPES:
        raise TypeError(f"attention_block_train: hidden must be float32 or bfloat16, got "
                        f"{hidden.dtype}")
    if hidden.dim() != 3 or hidden.shape[2] != H:
        raise ValueError(f"attention_block_train: hidden must be (B, L, {H}), got "
                         f"{tuple(hidden.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"attention_block_train: head_dim {hd} not supported {HEAD_DIMS}")
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"attention_block_train: dropout_rate {dropout_rate} not in [0, 1)")
    B, L, _ = hidden.shape
    dev = hidden.device
    seg = segment_ids.to(torch.int32).contiguous()
    seed = seed.to(torch.int32).contiguous()
    hidden = hidden.contiguous()
    for name, t, shape in (("segment_ids", seg, (B, L)), ("seed", seed, (1,)),
                           ("qkv_bias", qkv_bias, (3, nh, hd)),
                           ("out_kernel", out_kernel, (nh, hd, H)), ("out_bias", out_bias, (H,)),
                           ("qkv_kernel", qkv_kernel, (H, 3, nh, hd))):
        _check_card_tensor(f"attention_block_train: {name}", t.contiguous(), dev, shape)
    return _AttentionTrain.apply(hidden, seg, seed, qkv_kernel, qkv_bias, out_kernel, out_bias,
                                 float(sm_scale), float(dropout_rate))


def mlp_block_train(
    x: torch.Tensor,  # (M, H) compute dtype
    w1: torch.Tensor,  # (H, I) float32 parameter
    b1: torch.Tensor,  # (I,)
    w2: torch.Tensor,  # (I, H)
    b2: torch.Tensor,  # (H,)
    *,
    activation: str = "gelu",
) -> torch.Tensor:
    """Differentiable MLP core of the training path (no residual, LayerNorm
    or dropout); returns (M, H) in x's dtype."""
    if activation not in TRAIN_ACTIVATIONS:
        raise ValueError(f"mlp_block_train: activation {activation!r} not in {TRAIN_ACTIVATIONS}")
    if x.device.type == "cpu":
        return mlp_train_plain(x, w1, b1, w2, b2, activation=activation)
    if x.device.type != "cuda":
        raise ValueError(f"mlp_block_train: unsupported device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"mlp_block_train: x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 2:
        raise ValueError(f"mlp_block_train: x must be (M, H), got {tuple(x.shape)}")
    M, H = x.shape
    I = w1.shape[-1]
    for name, t, shape in (("w1", w1, (H, I)), ("b1", b1, (I,)), ("w2", w2, (I, H)),
                           ("b2", b2, (H,))):
        _check_card_tensor(f"mlp_block_train: {name}", t.contiguous(), x.device, shape)
    return _MlpTrain.apply(x.contiguous(), w1, b1, w2, b2, activation)
