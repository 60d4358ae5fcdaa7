"""PoNet: the multi-granularity pooling token mixer (no attention), PyTorch.

Counterpart of ``spokennlp_tpu/models/ponet.py``, with the Flax tree's
parameter names (``ponet.layer_i.mixer.{q,k,v,s,l,out}``, ``mixer_ln``,
``mlp_in``, ``mlp_out``, ``mlp_ln``, ``embeddings``, ``classifier``), so
``models/convert.py`` carries a JAX tree over with ``strict=True``; the tree
is the same on both mixer paths.

The mixer of a layer, ``ponet_mixer_impl``:

- ``"auto"`` and ``"xla"``: ``PoNetMixer``, the JAX package's XLA
  formulation in plain PyTorch, with its semantics exactly: pad tokens are
  forced into segment 0 with their s projections unmasked, segment ids
  >= L + 1 fall out of the segment max and are clamped in its gather (every
  such token then reads -1e9), ties on the max are excluded from the second
  max, and empty segments and the singleton fallback read -1e9. The pooling
  chain runs in the compute dtype, GA's sums accumulate in float32;
- ``"fused"``, at inference with ``ponet_ga_per_head=False``: the fused
  mixer block (ops/cuda/ponet_block.py; kernel 9 on the card), whose SMP
  pools over runs of adjacent ids with pad rows masked, so on padded rows
  it differs from the XLA mixer, as the JAX kernel does. Training always
  takes ``PoNetMixer`` (the kernel has no backward, in JAX neither). With
  ``ponet_ga_per_head=True`` the JAX package silently takes the XLA mixer;
  on CUDA the port raises and names ``ponet_mixer_impl='xla'``.

``quantize="w8a8"`` at inference: the six mixer projections through
``quant_dense`` (kernels 4 and 5 on the card) on the XLA path, the W8A8 mode
of the fused block on the fused path, and the MLP half through the W8A8 MLP
block (ops/cuda/mlp_block.py), as in JAX.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from spokennlp_tpu_torch.configs import EncoderConfig
from spokennlp_tpu_torch.models.encoder import (
    ACT2FN, NEG_INF, Dense, EncoderOutput, Embeddings, LayerNorm, dropout,
)
from spokennlp_tpu_torch.ops.cuda.int8_matmul import quant_dense
from spokennlp_tpu_torch.ops.cuda.mlp_block import fused_mlp_block
from spokennlp_tpu_torch.ops.cuda.ponet_block import fused_ponet_mixer_block

PROJECTIONS = ("q", "k", "v", "s", "l")


def segment_max_with_second(x: torch.Tensor, segment_ids: torch.Tensor, num_segments: int):
    """Per-segment channelwise (max, second max) of (B, L, D) x over (B, L)
    ids, as ``jax.ops.segment_max`` gives them: ids outside [0,
    num_segments) are dropped, empty segments read -1e9. The second max
    excludes every entry that ties the max. Returns (m1, m2), each (B,
    num_segments, D)."""
    B, L, D = x.shape
    S = num_segments
    valid = (segment_ids >= 0) & (segment_ids < S)
    # dropped ids go to a spare slot S that is cut off again
    slot = torch.where(valid, segment_ids, S).long()[..., None].expand(-1, -1, D)

    def seg_max(vals):
        init = torch.full((B, S + 1, D), -math.inf, dtype=vals.dtype, device=vals.device)
        m = init.scatter_reduce(1, slot, vals, "amax", include_self=True)[:, :S]
        return torch.where(torch.isfinite(m), m, torch.tensor(NEG_INF, dtype=m.dtype))

    m1 = seg_max(x)
    neg = torch.tensor(NEG_INF, dtype=x.dtype, device=x.device)
    x2 = torch.where(x >= _gather_segments(m1, segment_ids), neg, x)
    return m1, seg_max(x2)


def _gather_segments(m: torch.Tensor, segment_ids: torch.Tensor) -> torch.Tensor:
    """m[b, ids[b, l]] with the ids clamped into range (JAX's gather)."""
    S, D = m.shape[1], m.shape[2]
    idx = segment_ids.clamp(0, S - 1).long()[..., None].expand(-1, -1, D)
    return torch.gather(m, 1, idx)


def smp_second_max(x: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Segment max pooling with the second-max trick over (B, L, D): a token
    gets its segment's channel max, or the second max where it attains the
    max itself (the max again for singleton or all-equal segments)."""
    m1, m2 = segment_max_with_second(x, segment_ids, num_segments)
    tok_m1 = _gather_segments(m1, segment_ids)
    tok_m2 = _gather_segments(m2, segment_ids)
    tok_m2 = torch.where(tok_m2 <= NEG_INF / 2, tok_m1, tok_m2)
    return torch.where(x >= tok_m1, tok_m2, tok_m1)


def local_max_pool(x: torch.Tensor, window: int, mask: torch.Tensor) -> torch.Tensor:
    """Sliding-window max over the sequence axis of (B, L, D) x, masked
    tokens at -1e9, offsets -window // 2 .. window - 1 - window // 2."""
    neg = torch.where(mask.bool()[..., None], x, torch.tensor(NEG_INF, dtype=x.dtype))
    half = window // 2
    padded = F.pad(neg.transpose(1, 2), (half, window - 1 - half), value=-math.inf)
    return F.max_pool1d(padded, window, stride=1).transpose(1, 2)


class PoNetMixer(nn.Module):
    """The XLA formulation: five projections, GA + SMP + LMP, the out
    projection (``quantized``: all six on the W8A8 path)."""

    def __init__(self, cfg: EncoderConfig, generator=None):
        super().__init__()
        self.cfg = cfg
        H = cfg.hidden_size
        for name in PROJECTIONS + ("out",):
            self.add_module(name, Dense(H, H, generator))

    def project(self, name: str, x: torch.Tensor, quantized: bool) -> torch.Tensor:
        dense = getattr(self, name)
        if quantized:
            return quant_dense(x, dense.kernel, dense.bias, out_dtype=x.dtype)
        return dense(x)

    def forward(self, hidden, attention_mask, segment_ids, quantized: bool = False):
        cfg = self.cfg
        B, L, H = hidden.shape
        dt = hidden.dtype
        q, k, v, s_proj, l_proj = (self.project(n, hidden, quantized) for n in PROJECTIONS)
        maskc = attention_mask.to(dt)[..., None]

        # GA: masked mean query, one-query attention, cross fusion
        fuse_src = q if cfg.ponet_ga_fuse == "q" else v
        denom = attention_mask.float().sum(dim=1, keepdim=True).clamp_min(1.0)  # (B, 1)
        pad_bias = (1.0 - attention_mask.float()) * NEG_INF  # (B, L)
        if cfg.ponet_ga_per_head:
            nh, hd = cfg.num_heads, cfg.head_dim
            qh, kh, vh = (t.reshape(B, L, nh, hd) for t in (q, k, v))
            gh = ((qh * maskc[..., None]).float().sum(dim=1) / denom[..., None]).to(dt)
            att = torch.einsum("bnh,blnh->bln", gh.float(), kh.float()) / math.sqrt(hd)
            w = torch.softmax(att + pad_bias[..., None], dim=1).to(dt)
            g_prime = torch.einsum("bln,blnh->bnh", w.float(), vh.float()).to(dt)
            ga = (g_prime[:, None] * fuse_src.reshape(B, L, nh, hd)).reshape(B, L, H)
        else:
            g = ((q * maskc).float().sum(dim=1) / denom).to(dt)  # (B, H)
            scale = 1.0 / math.sqrt(cfg.head_dim * cfg.num_heads)
            att = (k * g[:, None, :]).float().sum(dim=-1)  # (B, L)
            w = torch.softmax(att * scale + pad_bias, dim=-1).to(dt)
            g_prime = (w[:, :, None] * v).float().sum(dim=1).to(dt)  # (B, H)
            ga = g_prime[:, None, :] * fuse_src

        # SMP: segments 1-based from the featurizer, pad tokens forced to 0
        seg = torch.where(attention_mask.bool(), segment_ids, 0)
        smp = smp_second_max(s_proj, seg, L + 1)
        lmp = local_max_pool(l_proj, cfg.ponet_local_window, attention_mask)
        return self.project("out", ga + smp + lmp, quantized)


def mixer_path(cfg: EncoderConfig, device: torch.device, training: bool) -> str:
    """"fused" or "xla", as the JAX layer resolves ``ponet_mixer_impl``
    ("auto" is "xla"); raises on CUDA where JAX would silently leave a
    "fused" request."""
    impl = cfg.ponet_mixer_impl
    if impl not in ("auto", "xla", "fused"):
        raise ValueError(f"ponet_mixer_impl={impl!r}")
    if impl != "fused" or training:
        return "xla"
    if cfg.ponet_ga_per_head:
        if device.type == "cuda":
            raise ValueError("ponet_mixer_impl='fused' needs ponet_ga_per_head=False (the fused "
                             "block computes the single-head GA); ask for "
                             "ponet_mixer_impl='xla'")
        return "xla"
    return "fused"


class PoNetLayer(nn.Module):
    """Mixer half (mixer, dropout, residual, ``mixer_ln``) and MLP half.
    ``mixer_block`` is the fused block's entry (swappable for its plain
    version, to compare the two on the card)."""

    def __init__(self, cfg: EncoderConfig, generator=None):
        super().__init__()
        self.cfg = cfg
        H, I = cfg.hidden_size, cfg.intermediate_size
        self.mixer = PoNetMixer(cfg, generator)
        self.mixer_ln = LayerNorm(H, cfg.layer_norm_eps)
        self.mlp_in = Dense(H, I, generator)
        self.mlp_out = Dense(I, H, generator)
        self.mlp_ln = LayerNorm(H, cfg.layer_norm_eps)
        self.mixer_block = fused_ponet_mixer_block

    def forward(self, hidden, attention_mask, segment_ids, generator=None):
        cfg = self.cfg
        rate = cfg.hidden_dropout
        quantized = cfg.quantize == "w8a8" and not self.training
        if mixer_path(cfg, hidden.device, self.training) == "fused":
            mixer = self.mixer
            hidden = self.mixer_block(
                hidden, attention_mask, segment_ids,
                torch.stack([getattr(mixer, n).kernel for n in PROJECTIONS]),
                torch.stack([getattr(mixer, n).bias for n in PROJECTIONS]),
                mixer.out.kernel, mixer.out.bias, local_window=cfg.ponet_local_window,
                sm_scale=1.0 / math.sqrt(cfg.head_dim * cfg.num_heads), quantized=quantized,
                ln_scale=self.mixer_ln.scale, ln_bias=self.mixer_ln.bias, eps=cfg.layer_norm_eps)
        else:
            mixed = self.mixer(hidden, attention_mask, segment_ids, quantized)
            mixed = dropout(mixed, rate, self.training, generator)
            hidden = self.mixer_ln(hidden + mixed)
        if quantized:
            B, L, H = hidden.shape
            out = fused_mlp_block(
                hidden.reshape(B * L, H), self.mlp_in.kernel, self.mlp_in.bias,
                self.mlp_out.kernel, self.mlp_out.bias, self.mlp_ln.scale, self.mlp_ln.bias,
                activation=cfg.hidden_act, eps=cfg.layer_norm_eps, quantized=True)
            return out.reshape(B, L, H)
        mlp = self.mlp_out(ACT2FN[cfg.hidden_act](self.mlp_in(hidden)))
        mlp = dropout(mlp, rate, self.training, generator)
        return self.mlp_ln(hidden + mlp)


class PoNetEncoder(nn.Module):
    """Embeddings + N PoNet layers (+ optional pooler)."""

    def __init__(self, cfg: EncoderConfig, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.embeddings = Embeddings(cfg, dtype, generator)
        for i in range(cfg.num_layers):
            self.add_module(f"layer_{i}", PoNetLayer(cfg, generator))
        self.pooler = (
            Dense(cfg.hidden_size, cfg.hidden_size, generator) if cfg.add_pooler else None
        )

    def layers(self):
        return [getattr(self, f"layer_{i}") for i in range(self.cfg.num_layers)]

    def forward(self, input_ids, attention_mask=None, token_type_ids=None, segment_ids=None,
                position_ids=None, output_hidden_states: bool = False,
                generator: Optional[torch.Generator] = None) -> EncoderOutput:
        B, L = input_ids.shape
        ones = lambda: torch.ones((B, L), dtype=torch.int32, device=input_ids.device)
        attention_mask = ones() if attention_mask is None else attention_mask
        segment_ids = ones() if segment_ids is None else segment_ids
        hidden = self.embeddings(input_ids, token_type_ids, position_ids, generator)
        all_hidden = (hidden,) if output_hidden_states else None
        for layer in self.layers():
            hidden = layer(hidden, attention_mask, segment_ids, generator)
            if output_hidden_states:
                all_hidden = all_hidden + (hidden,)
        pooled = torch.tanh(self.pooler(hidden[:, 0])) if self.pooler is not None else None
        return EncoderOutput(last_hidden_state=hidden, pooled_output=pooled,
                             hidden_states=all_hidden)


class PoNetForTokenClassification(nn.Module):
    """PoNet trunk + dropout + linear head (reference wrapper:
    modeling_ponet.py:34-119)."""

    def __init__(self, cfg: EncoderConfig, num_labels: int = 2,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.ponet = PoNetEncoder(cfg, dtype, generator)
        self.classifier = Dense(cfg.hidden_size, num_labels, generator)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None, segment_ids=None,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        out = self.ponet(input_ids, attention_mask=attention_mask,
                         token_type_ids=token_type_ids, segment_ids=segment_ids,
                         generator=generator)
        seq = dropout(out.last_hidden_state, self.cfg.hidden_dropout, self.training, generator)
        return {"seq_output": seq, "token_logits": self.classifier(seq)}
