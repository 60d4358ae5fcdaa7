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

Dropout draws keep bits from Philox4x32-10 keyed by the seed, one per
(sequence, head, query row, key column), and keeps a probability iff its
bits are >= ``min(int(rate * 2**32), 2**32 - 1)``, as the TPU kernel
thresholds its hardware bits. ``philox_bits`` is the numpy twin of the
kernels' generator, so the plain version replays the kernels' mask exactly;
``dropout_keep_mask`` gives that mask on either device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from spokennlp_tpu_torch.ops.cuda import build
from spokennlp_tpu_torch.ops.cuda.attention_block import _DTYPES, HEAD_DIMS, NEG_INF
from spokennlp_tpu_torch.ops.cuda.int8_matmul import ACTIVATION_CODES, ACTIVATIONS

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
    1 / (1 - rate). Masked keys get an additive -1e9, as in the kernels."""
    x = hidden.float()
    qkv = torch.einsum("blh,hsnd->blsnd", x, qkv_kernel.float()) + qkv_bias.float()
    q, k, v = qkv.unbind(2)  # (B, L, nh, hd)
    scores = torch.einsum("blnd,bmnd->bnlm", q, k) * sm_scale
    seg = segment_ids
    allowed = (seg[:, :, None] == seg[:, None, :]) & (seg[:, None, :] > 0)
    scores = scores + torch.where(allowed, 0.0, NEG_INF)[:, None]
    probs = torch.softmax(scores, dim=-1)
    if dropout_rate > 0.0:
        if keep is None:
            raise ValueError("attention_train_plain: dropout_rate > 0 needs the keep mask")
        probs = torch.where(keep, probs / (1.0 - dropout_rate), 0.0)
    ctx = torch.einsum("bnlm,bmnd->blnd", probs, v)
    out = torch.einsum("blnd,ndh->blh", ctx, out_kernel.float()) + out_bias.float()
    return out.to(hidden.dtype)


def mlp_train_plain(x, w1, b1, w2, b2, *, activation: str) -> torch.Tensor:
    """act(x W1 + b1) W2 + b2 in plain float32 PyTorch; returns x's dtype."""
    xf = x.float()
    h = ACTIVATIONS[activation](xf @ w1.float() + b1.float())
    return (h @ w2.float() + b2.float()).to(x.dtype)


# ------------------------------------------------------------ kernel calls


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


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
                        sm_scale: float, dropout_rate: float) -> torch.Tensor:
    """Forward kernel: hidden (B, L, H) and the weights wqkv (H, 3 Hn), wo
    (Hn, H) in the compute dtype, biases bqkv (3 Hn,), bo (H,) float32, seg
    (B, L) and seed (1,) int32, all on one card. ``attention_train_fwd.
    launches`` counts its launches."""
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
    return out


def attention_train_bwd(hidden, seg, seed, wqkv, bqkv, wo, g, *, num_heads: int,
                        sm_scale: float, dropout_rate: float):
    """Backward kernel: recomputes the forward from its inputs and returns
    (dx in the compute dtype, dWqkv (H, 3 Hn), dbqkv (3 Hn,), dWo (Hn, H),
    dbo (H,) in float32, summed over the batch). ``attention_train_bwd.
    launches`` counts its launches."""
    B, L, H = hidden.shape
    HN = wo.shape[0]
    hd = HN // num_heads
    dev, dt = hidden.device, hidden.dtype
    empty = lambda *s, dtype=dt: torch.empty(s, dtype=dtype, device=dev)
    qkv_buf, dctx_buf, ctx_buf = empty(3, B, num_heads, L, hd), empty(B, L, HN), empty(B, L, HN)
    stats, dqkv = empty(3, B, num_heads, L, dtype=torch.float32), empty(B, L, 3 * HN)
    dx = torch.empty_like(hidden)
    f32 = torch.float32
    dwqkv, dbqkv = empty(H, 3 * HN, dtype=f32), empty(3 * HN, dtype=f32)
    dwo, dbo = empty(HN, H, dtype=f32), empty(H, dtype=f32)
    ptrs = [t.data_ptr() for t in (hidden, seg, seed, wqkv, bqkv, wo, g, qkv_buf, dctx_buf,
                                   ctx_buf, stats, dqkv, dx, dwqkv, dbqkv, dwo, dbo)]
    with torch.cuda.device(dev):
        code = build.library().spk_attention_train_bwd(
            _DTYPES[dt], *ptrs, B, L, H, num_heads, hd, float(sm_scale),
            dropout_threshold(dropout_rate), 1.0 - dropout_rate, _stream(),
        )
    build.check(code, "attention_train_bwd")
    attention_train_bwd.launches += 1
    return dx, dwqkv, dbqkv, dwo, dbo


def mlp_train_fwd(x, w1, b1, w2, b2, *, activation: str) -> torch.Tensor:
    """Forward kernel: x (M, H), w1 (H, I), w2 (I, H) in the compute dtype,
    b1, b2 float32. ``mlp_train_fwd.launches`` counts its launches."""
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
    return out


def mlp_train_bwd(x, w1, b1, w2, g, *, activation: str):
    """Backward kernel: recomputes the intermediate and returns (dx in the
    compute dtype, dW1, db1, dW2, db2 in float32, summed over the rows).
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
    ptrs = [t.data_ptr() for t in (x, w1, b1, w2, g, h_buf, hgrad_buf, dpre_buf, dx, dw1, db1,
                                   dw2, db2)]
    with torch.cuda.device(dev):
        code = build.library().spk_mlp_train_bwd(
            _DTYPES[dt], *ptrs, M, H, I, ACTIVATION_CODES[activation], _stream(),
        )
    build.check(code, "mlp_train_bwd")
    mlp_train_bwd.launches += 1
    return dx, dw1, db1, dw2, db2


for _fn in (attention_train_fwd, attention_train_bwd, mlp_train_fwd, mlp_train_bwd):
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
