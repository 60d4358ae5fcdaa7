"""Segment-masked self-attention over an already projected qkv.

Counterpart of ``spokennlp_tpu/ops/pallas/blhd_attention.py``, which serves
``attention_impl="pallas"``: (B, 3, nh, L, hd) -> (B, nh, L, hd), scores
(q . k) * sm_scale with the additive -1e9 mask of allowed = (seg_q == seg_k)
& (seg_k > 0). On a CUDA tensor ``snld_self_attention`` runs the kernel of
``csrc/blhd_attention.cu`` (exp in bfloat16, normalised after P.V, as the
TPU kernel computes it); on a CPU tensor it runs
``reference_snld_attention``, JAX's reference of the same function with a
float32 softmax. ``snld_attention_plain`` repeats the kernel's own
arithmetic (the online softmax over key tiles of 64 of
``csrc/attention_core.cuh``, every rounding where the kernel rounds), so the
card can hold the kernel to it within one bf16 step of the output;
``attention_block_model`` does the same for the whole float attention block
(kernel 1) around that core.
"""

from __future__ import annotations

import torch

from spokennlp_tpu_torch.ops.cuda import attention_block as ab
from spokennlp_tpu_torch.ops.cuda import attention_models as am
from spokennlp_tpu_torch.ops.cuda import build
from spokennlp_tpu_torch.ops.cuda.attention_block import HEAD_DIMS, NEG_INF
from spokennlp_tpu_torch.ops.cuda.int8_matmul import DTYPE_CODES


def reference_snld_attention(qkv: torch.Tensor, segment_ids: torch.Tensor,
                             sm_scale: float) -> torch.Tensor:
    """JAX's ``reference_snld_attention``: float32 softmax, probabilities
    rounded to qkv's type before P.V; returns (B, nh, L, hd) in qkv's type."""
    q, k, v = qkv[:, 0], qkv[:, 1], qkv[:, 2]  # (B, nh, L, hd)
    scores = torch.einsum("bnld,bnmd->bnlm", q.float() * sm_scale, k.float())
    seg = segment_ids
    allowed = (seg[:, :, None] == seg[:, None, :]) & (seg[:, None, :] > 0)
    scores = torch.where(allowed[:, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bnlm,bnmd->bnld", probs.float(), v.float()).to(qkv.dtype)


CORE_KEY_TILE = 64  # the key tile of csrc/attention_core.cuh (kTile)


def core_allowed(segment_ids: torch.Tensor) -> torch.Tensor:
    """(B, 1, L, L): key m is allowed for query l iff seg[l] == seg[m] > 0."""
    seg = segment_ids
    return ((seg[:, :, None] == seg[:, None, :]) & (seg[:, None, :] > 0))[:, None]


def core_alpha(m_old: torch.Tensor, m_new: torch.Tensor) -> torch.Tensor:
    """The online softmax's rescale of the running sums, exp(m_old - m_new),
    unrounded."""
    return torch.exp(m_old - m_new)


def snld_attention_plain(qkv: torch.Tensor, segment_ids: torch.Tensor,
                         sm_scale: float) -> torch.Tensor:
    """Kernel 6's own arithmetic, the dense core of
    ``csrc/attention_core.cuh`` with every rounding where the kernel
    rounds: scores (q . k) * sm_scale in float32 plus -1e9 where a key is
    not allowed; per key tile of 64 the running max m, e = exp(s - m) with
    s - m and e rounded to bfloat16, e rounded to qkv's type before it
    meets v, float32 sums of the rounded e, both rescaled by
    ``core_alpha``; the context divided by the sum after P.V, then rounded
    to qkv's type. Both products go through
    ``attention_models.core_product``. Returns (B, nh, L, hd)."""
    q, k, v = (qkv[:, i].float() for i in range(3))  # (B, nh, L, hd)
    B, nh, L, hd = q.shape
    bias = torch.where(core_allowed(segment_ids), 0.0, NEG_INF)
    m = torch.full((B, nh, L, 1), float("-inf"), device=q.device)
    total = torch.zeros((B, nh, L, 1), device=q.device)
    o = torch.zeros((B, nh, L, hd), device=q.device)
    for k0 in range(0, L, CORE_KEY_TILE):
        keys = slice(k0, k0 + CORE_KEY_TILE)
        s = am.core_product(q, k[:, :, keys].transpose(-1, -2)) * sm_scale + bias[..., keys]
        new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = core_alpha(m, new)
        e = torch.exp((s - new).to(torch.bfloat16)).to(qkv.dtype).float()
        total = total * alpha + e.sum(dim=-1, keepdim=True)
        o = o * alpha + am.core_product(e, v[:, :, keys])
        m = new
    return (o / total).to(qkv.dtype)


def attention_block_model(hidden, segment_ids, qkv_kernel, qkv_bias, out_kernel, out_bias, *,
                          sm_scale: float, ln_scale=None, ln_bias=None,
                          eps: float = 1e-12) -> torch.Tensor:
    """Kernel 1's own arithmetic in its float modes, every rounding where
    the kernel rounds: q = (x Wq + bq) sm_scale, k = x Wk + bk, v = x Wv + bv
    with float32 sums, rounded to hidden's type; the core's rounding model
    (``snld_attention_plain`` on the scaled q); ctx rounded; out = ctx Wo +
    bo, plus x and the LayerNorm with ``ln_scale``, in float32, rounded.
    Both products go through ``attention_block.float_product``. Returns (B,
    L, H) in hidden's type; compare rows with segment_ids > 0."""
    B, L, H = hidden.shape
    _, _, nh, hd = qkv_kernel.shape
    x, dt = hidden.float(), hidden.dtype
    qkv = ab.float_product(x, qkv_kernel.reshape(H, -1)).reshape(B, L, 3, nh, hd)
    qkv = qkv + qkv_bias.float()
    scale = torch.tensor([sm_scale, 1.0, 1.0], device=x.device)[:, None, None]
    qkv = (qkv * scale).to(dt).permute(0, 2, 3, 1, 4)  # (B, 3, nh, L, hd)
    ctx = snld_attention_plain(qkv, segment_ids, 1.0).transpose(1, 2).reshape(B, L, nh * hd)
    out = ab.float_product(ctx, out_kernel.reshape(-1, H)) + out_bias.float()
    if ln_scale is not None:
        out = ab._layer_norm(out + x, ln_scale, ln_bias, eps)
    return out.to(dt)


def snld_self_attention(
    qkv: torch.Tensor,  # (B, 3, nh, L, hd) float32 or bfloat16
    segment_ids: torch.Tensor,  # (B, L) int; 0 = padding, >0 = segment id
    sm_scale: float,
) -> torch.Tensor:
    """Fused non-causal self-attention; returns (B, nh, L, hd).
    ``snld_self_attention.launches`` counts the calls that ran the kernel on
    the card."""
    if qkv.device.type == "cpu":
        return reference_snld_attention(qkv, segment_ids, sm_scale)
    if qkv.device.type != "cuda":
        raise ValueError(f"snld_self_attention: unsupported device {qkv.device}")
    if qkv.dtype not in DTYPE_CODES:
        raise TypeError(f"snld_self_attention: qkv must be float32 or bfloat16, got {qkv.dtype}")
    if qkv.dim() != 5 or qkv.shape[1] != 3:
        raise ValueError(f"snld_self_attention: qkv must be (B, 3, nh, L, hd), got {tuple(qkv.shape)}")
    B, _, nh, L, hd = qkv.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"snld_self_attention: head_dim {hd} not supported {HEAD_DIMS}")
    if tuple(segment_ids.shape) != (B, L) or segment_ids.device != qkv.device:
        raise ValueError(f"snld_self_attention: segment_ids must be ({B}, {L}) on {qkv.device}")
    if segment_ids.dtype.is_floating_point:
        raise TypeError("snld_self_attention: segment_ids must be integers")
    x = qkv.contiguous()
    if x.data_ptr() % 16:  # the bf16 core copies 16 bytes at a time
        x = x.clone()
    seg = segment_ids.to(torch.int32).contiguous()
    out = torch.empty((B, nh, L, hd), dtype=qkv.dtype, device=qkv.device)
    with torch.cuda.device(qkv.device):
        code = build.library().spk_snld_attention(
            DTYPE_CODES[qkv.dtype], x.data_ptr(), seg.data_ptr(), out.data_ptr(), B, L, nh, hd,
            float(sm_scale), torch.cuda.current_stream().cuda_stream,
        )
    build.check(code, "snld_self_attention")
    snld_self_attention.launches += 1
    return out


snld_self_attention.launches = 0
