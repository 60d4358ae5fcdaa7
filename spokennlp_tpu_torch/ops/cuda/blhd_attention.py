"""Segment-masked self-attention over an already projected qkv.

Counterpart of ``spokennlp_tpu/ops/pallas/blhd_attention.py``, which serves
``attention_impl="pallas"``: (B, 3, nh, L, hd) -> (B, nh, L, hd), scores
(q . k) * sm_scale with the additive -1e9 mask of allowed = (seg_q == seg_k)
& (seg_k > 0). On a CUDA tensor ``snld_self_attention`` runs the kernel of
``csrc/blhd_attention.cu`` (exp in bfloat16, normalised after P.V, as the
TPU kernel computes it); on a CPU tensor it runs
``reference_snld_attention``, JAX's reference of the same function with a
float32 softmax.
"""

from __future__ import annotations

import torch

from spokennlp_tpu_torch.ops.cuda import build
from spokennlp_tpu_torch.ops.cuda.attention_block import NEG_INF
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
    if hd not in (32, 64, 128):
        raise ValueError(f"snld_self_attention: head_dim {hd} not supported (32, 64 or 128)")
    if tuple(segment_ids.shape) != (B, L) or segment_ids.device != qkv.device:
        raise ValueError(f"snld_self_attention: segment_ids must be ({B}, {L}) on {qkv.device}")
    if segment_ids.dtype.is_floating_point:
        raise TypeError("snld_self_attention: segment_ids must be integers")
    x = qkv.contiguous()
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
