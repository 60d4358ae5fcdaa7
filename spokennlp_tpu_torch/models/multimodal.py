"""MMVTS multimodal model stack, PyTorch: projectors, cross-encoders, a real
top-k MoE, predictors.

Counterpart of ``spokennlp_tpu/models/multimodal.py`` (the reference's
mmvts/src/models/multi_modal_for_ts.py:22-213 and
src/models/{projector,cross_encoder,predictor}/*). Everything stays (B, K,
D) with a clip mask, as in JAX:

- "ma" merge-attention: modalities concatenated on the sequence axis (text,
  vis, audio order), N post-LN self-attention layers, chunked back;
- "ca" co-attention: each modality cross-attends to the feature-axis concat
  of the others (kv width 2H with three modalities);
- "ma_moe" / "ca_moe": a top-k gated mixture of FFN experts after each layer
  (or one bank shared by every layer) with the cv^2 balance loss; ``moe_impl``
  "dense" runs every expert on every token, "dispatch" GShard's capacity
  dispatch (``dispatch_plan`` / ``dispatch_experts``).

JAX's semantics kept: masks are an additive -1e9 with the softmax in
float32; GELU is the exact erf form; ``jax.lax.top_k``'s tie order (the
lower index first, ``models/generation.py top_k``); ``jnp.var``'s population
variance; the capacity C = max(8, ceil(ceil(N K / E cf) / 8) 8) and the
k-major float32 cumsum priority. The dispatch takes index ops in place of
JAX's one-hot einsums: a dropped assignment (position >= C, or a masked
token) goes to one spare slot that is thrown away, so the same tokens drop.
The transformer predictor's layers never drop out (JAX calls them without
``deterministic``).

Parameter names follow the Flax tree (``qkv.kernel`` (H, 3, nh, hd),
``out.kernel`` (nh, hd, H), the MoE's ``w_in`` (E, H, I) and ``w_out`` (E, I,
H) as plain tensors, the hybrid predictor's ``modal_weights``), so a JAX tree
loads with ``load_state_dict(jax_params_to_state_dict(tree), strict=True)``.
``module.training`` plays JAX's ``deterministic=False``; dropout masks come
from the ``generator`` given to ``forward``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from spokennlp_tpu_torch.models.encoder import (
    AttnOutProj, Dense, FusedQKV, LayerNorm, dropout,
)
from spokennlp_tpu_torch.models.generation import top_k
from spokennlp_tpu_torch.models.seq2seq import HeadsOut, HeadsProj

NEG_INF = -1e9
MODALITIES = ("text", "vis", "audio")


@dataclasses.dataclass(frozen=True)
class MultimodalConfig:
    hidden_size: int = 256  # common projected width
    text_hidden_size: int = 768
    vis_hidden_size: int = 768  # vis2d (+ vis3d + ocr) concat width
    audio_hidden_size: int = 768
    projector_type: str = "linear"  # linear | transformer
    proj_num_layers: int = 1  # transformer projector depth
    proj_skip: bool = False  # residual around the projector encoder
    cross_encoder_type: str = "ma"  # ma | ca | ma_moe | ca_moe | none
    num_cross_encoder_layers: int = 2
    num_cross_encoder_heads: int = 8
    intermediate_size: int = 1024
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    layer_norm_eps: float = 1e-12
    fuse_type: str = "cat"  # cat | mean | max | text_only | vis_only | audio_only
    #                         | cat_a_t | cat_a_v | cat_t_v
    predictor_type: str = "linear"  # linear | transformer | hybrid
    predictor_hybrid_weight_type: str = "p"  # p | l
    predictor_hybrid_pooling: str = "mean"  # mean | max
    num_labels: int = 2
    out_modal_prob: bool = False
    moe_num_experts: int = 4
    moe_top_k: int = 2
    moe_loss_weight: float = 0.01
    moe_residual: bool = True
    moe_share_in_layers: bool = False
    moe_impl: str = "dense"  # dense | dispatch
    moe_capacity_factor: float = 1.25

    @property
    def modalities(self) -> Tuple[str, ...]:
        return {"text_only": ("text",), "vis_only": ("vis",), "audio_only": ("audio",),
                "cat_a_t": ("text", "audio"), "cat_a_v": ("vis", "audio"),
                "cat_t_v": ("text", "vis")}.get(self.fuse_type, MODALITIES)

    @property
    def fused_width(self) -> int:
        if self.fuse_type.startswith("cat"):
            return self.hidden_size * len(self.modalities)
        return self.hidden_size

    def input_width(self, modality: str) -> int:
        return {"text": self.text_hidden_size, "vis": self.vis_hidden_size,
                "audio": self.audio_hidden_size}[modality]


def _attend(q, k, v, key_mask, rate: float, deterministic: bool, generator):
    """Scaled dot-product attention of (B, L, nh, hd) q over (B, M, nh, hd)
    k and v with an additive -1e9 key mask, the softmax in float32."""
    dt = q.dtype
    hd = q.shape[-1]
    scores = torch.einsum("blhd,bmhd->bhlm", q * (1.0 / math.sqrt(hd)), k)
    bias = (1.0 - key_mask[:, None, None, :].float()) * NEG_INF
    probs = F.softmax((scores + bias.to(scores.dtype)).float(), dim=-1).to(dt)
    probs = dropout(probs, rate, not deterministic, generator)
    return torch.einsum("bhlm,bmhd->blhd", probs, v)


class _PostLNBlock(nn.Module):
    """The residual, LayerNorm and erf-GELU MLP shared by both attention
    layers: ``attn_ln``, ``mlp_in``, ``mlp_out``, ``mlp_ln``."""

    def __init__(self, cfg: MultimodalConfig, H: int, generator=None):
        super().__init__()
        self.cfg = cfg
        self.attn_ln = LayerNorm(H, cfg.layer_norm_eps)
        self.mlp_in = Dense(H, cfg.intermediate_size, generator)
        self.mlp_out = Dense(cfg.intermediate_size, H, generator)
        self.mlp_ln = LayerNorm(H, cfg.layer_norm_eps)

    def finish(self, x, attn, deterministic: bool, generator):
        rate = self.cfg.hidden_dropout
        x = self.attn_ln(x + dropout(attn, rate, not deterministic, generator))
        mlp = self.mlp_out(F.gelu(self.mlp_in(x), approximate="none"))
        return self.mlp_ln(x + dropout(mlp, rate, not deterministic, generator))


class DenseSelfAttentionLayer(_PostLNBlock):
    """BERT-style post-LN self-attention + FFN block over clip features."""

    def __init__(self, cfg: MultimodalConfig, H: int, generator=None):
        super().__init__(cfg, H, generator)
        nh = cfg.num_cross_encoder_heads
        self.qkv = FusedQKV(H, nh, H // nh, generator)
        self.out = AttnOutProj(nh, H // nh, H, generator)

    def forward(self, x, key_mask, deterministic: bool = True, generator=None):
        q, k, v = self.qkv(x).unbind(2)
        ctx = _attend(q, k, v, key_mask, self.cfg.attention_dropout, deterministic, generator)
        return self.finish(x, self.out(ctx), deterministic, generator)


class CrossAttentionLayer(_PostLNBlock):
    """The query modality attends to another modality's features
    (reference: cross_encoder/bert_model.py BertCrossLayer usage)."""

    def __init__(self, cfg: MultimodalConfig, H: int, kv_width: int, generator=None):
        super().__init__(cfg, H, generator)
        nh = cfg.num_cross_encoder_heads
        self.q = HeadsProj(H, nh, H // nh, generator)
        self.k = HeadsProj(kv_width, nh, H // nh, generator)
        self.v = HeadsProj(kv_width, nh, H // nh, generator)
        self.out = HeadsOut(nh, H // nh, H, generator)

    def forward(self, x, kv, key_mask, deterministic: bool = True, generator=None):
        ctx = _attend(self.q(x), self.k(kv), self.v(kv), key_mask, self.cfg.attention_dropout,
                      deterministic, generator)
        return self.finish(x, self.out(ctx), deterministic, generator)


# ---------------------------------------------------------------------- MoE


def capacity(n_tokens: int, cfg: MultimodalConfig) -> int:
    """Slots an expert: ceil(N K / E cf), rounded up to a multiple of 8, at
    least 8."""
    c = int(math.ceil(n_tokens * cfg.moe_top_k / cfg.moe_num_experts * cfg.moe_capacity_factor))
    return max(8, int(math.ceil(c / 8)) * 8)


def route(gate_logits: torch.Tensor, k: int, num_experts: int):
    """(top-k expert ids, their softmaxed gates, the (…, E) dense gates)."""
    topv, topi = top_k(gate_logits, k)
    gates_k = F.softmax(topv, dim=-1)
    dense = torch.einsum("...k,...ke->...e", gates_k, F.one_hot(topi, num_experts).float())
    return topi, gates_k, dense


def balance_loss(dense_gates: torch.Tensor, mask: torch.Tensor, weight: float) -> torch.Tensor:
    """weight * (cv^2(importance) + cv^2(load)) over the valid tokens, with
    the population variance (``jnp.var``)."""
    maskf = mask.float()[..., None]
    importance = torch.sum(dense_gates * maskf, dim=(0, 1))
    load = torch.sum((dense_gates > 0).float() * maskf, dim=(0, 1))

    def cv_squared(v):
        return torch.var(v, unbiased=False) / (torch.mean(v) ** 2 + 1e-10)

    return weight * (cv_squared(importance) + cv_squared(load))


def dispatch_plan(mask: torch.Tensor, topi: torch.Tensor, gates_k: torch.Tensor,
                  cfg: MultimodalConfig):
    """GShard's capacity dispatch over the N = B L tokens: (slot (N, K) into
    the (E C + 1) slot table, the last slot taking every dropped
    assignment; gate (N, K), 0 where dropped; C). Choice 0 of every token
    outranks any choice 1 (a float32 cumsum over the k-major flattening)."""
    E, K = cfg.moe_num_experts, cfg.moe_top_k
    N = mask.numel()
    C = capacity(N, cfg)
    maskf = mask.reshape(N).float()
    topi = topi.reshape(N, K)
    onehot_e = F.one_hot(topi, E).float() * maskf[:, None, None]  # (N, K, E)
    flat = onehot_e.transpose(0, 1).reshape(K * N, E)
    pos_before = torch.cumsum(flat, dim=0) - flat
    pos = (pos_before.reshape(K, N, E).transpose(0, 1) * onehot_e).sum(-1)  # (N, K)
    keep = (pos < C) & (maskf[:, None] > 0)
    slot = torch.where(keep, topi * C + pos.long(), E * C)
    gate = torch.where(keep, gates_k.reshape(N, K) * maskf[:, None], 0.0)
    return slot, gate, C


def dispatch_experts(xf: torch.Tensor, slot: torch.Tensor, gate: torch.Tensor, C: int,
                     w_in: torch.Tensor, w_out: torch.Tensor, first_expert: int = 0):
    """The experts ``first_expert ..`` (``w_in`` (e, H, I), ``w_out`` (e, I,
    H)) over their capacity slots: each slot holds its token's (N, H) float32
    row or zeros, and each token gets its kept choices' outputs times their
    gates. With every expert this is the layer's output; with one rank's
    experts its share of it (the expert-sharded dry run sums the shares)."""
    N, K = slot.shape
    n_local = w_in.shape[0]
    lo = first_expert * C
    local = slot - lo
    # slots of other ranks' experts and dropped assignments: the spare slot
    local = torch.where((local >= 0) & (local < n_local * C), local, n_local * C)
    table = torch.zeros(n_local * C + 1, xf.shape[1], dtype=xf.dtype, device=xf.device)
    rows = xf[:, None, :].expand(N, K, xf.shape[1]).reshape(N * K, -1)
    table = table.index_add(0, local.reshape(-1), rows)
    expert_in = table[:-1].reshape(n_local, C, -1)
    hidden = F.gelu(torch.einsum("ech,ehi->eci", expert_in, w_in), approximate="none")
    expert_out = torch.einsum("eci,eih->ech", hidden, w_out).reshape(n_local * C, -1)
    expert_out = torch.cat([expert_out, expert_out.new_zeros(1, expert_out.shape[1])])
    picked = expert_out[local.reshape(-1)].reshape(N, K, -1)
    return torch.einsum("nk,nkh->nh", gate, picked)


class MoELayer(nn.Module):
    """Top-k gated mixture of FFN experts with the cv^2 balance loss: the
    reference's stub (moe.py:4-14) made real, after tensor2tensor's
    expert_utils. Returns (x + y or y, aux)."""

    def __init__(self, cfg: MultimodalConfig, H: int, generator=None):
        super().__init__()
        self.cfg = cfg
        E, inter = cfg.moe_num_experts, cfg.intermediate_size
        self.gate = Dense(H, E, generator)
        self.w_in = nn.Parameter(torch.empty(E, H, inter))
        self.w_out = nn.Parameter(torch.empty(E, inter, H))
        nn.init.normal_(self.w_in.data, std=0.02, generator=generator)
        nn.init.normal_(self.w_out.data, std=0.02, generator=generator)

    def forward(self, x, mask, deterministic: bool = True, generator=None):
        c = self.cfg
        B, L, H = x.shape
        gate_logits = self.gate(x.float())  # the gate runs in float32
        topi, gates_k, dense_gates = route(gate_logits, c.moe_top_k, c.moe_num_experts)
        if c.moe_impl == "dispatch":
            slot, gate, C = dispatch_plan(mask, topi, gates_k, c)
            y = dispatch_experts(x.reshape(B * L, H).float(), slot, gate, C, self.w_in,
                                 self.w_out).reshape(B, L, H).to(x.dtype)
        elif c.moe_impl == "dense":
            hidden = F.gelu(torch.einsum("blh,ehi->blei", x.float(), self.w_in),
                            approximate="none")
            expert_out = torch.einsum("blei,eih->bleh", hidden, self.w_out)
            y = torch.einsum("bleh,ble->blh", expert_out, dense_gates).to(x.dtype)
        else:
            raise ValueError(f"moe_impl={c.moe_impl!r}")
        aux = balance_loss(dense_gates, mask, c.moe_loss_weight)
        return (x + y if c.moe_residual else y), aux


# ------------------------------------------------------------ cross-encoders


def _present(feats: Dict[str, torch.Tensor]):
    return [m for m in MODALITIES if m in feats]


class _CrossEncoder(nn.Module):
    def __init__(self, cfg: MultimodalConfig, use_moe: bool, generator=None):
        super().__init__()
        self.cfg, self.use_moe = cfg, use_moe
        H = cfg.hidden_size
        if use_moe and cfg.moe_share_in_layers:
            self.moe_shared = MoELayer(cfg, H, generator)
        elif use_moe:
            for i in range(cfg.num_cross_encoder_layers):
                self.add_module(f"moe_{i}", MoELayer(cfg, H, generator))

    def moe(self, i: int) -> MoELayer:
        return self.moe_shared if self.cfg.moe_share_in_layers else getattr(self, f"moe_{i}")

    def seq_moe(self, i, cur, names, mask, deterministic, generator):
        """One MoE over the sequence-axis concat of the modalities, chunked
        back (reference: ca_moe_encoder.py:89-117)."""
        z = torch.cat([cur[m] for m in names], dim=1)
        z, aux = self.moe(i)(z, torch.cat([mask] * len(names), dim=1), deterministic,
                             generator)
        K = mask.shape[1]
        return {m: z[:, j * K:(j + 1) * K] for j, m in enumerate(names)}, aux


class MergeAttentionEncoder(_CrossEncoder):
    """"ma": concat modalities on the sequence axis -> self-attention ->
    chunk."""

    def __init__(self, cfg: MultimodalConfig, use_moe: bool = False, generator=None):
        super().__init__(cfg, use_moe, generator)
        for i in range(cfg.num_cross_encoder_layers):
            self.add_module(f"layer_{i}", DenseSelfAttentionLayer(cfg, cfg.hidden_size,
                                                                  generator))

    def forward(self, feats, mask, deterministic: bool = True, generator=None):
        names = _present(feats)
        z = torch.cat([feats[m] for m in names], dim=1)
        cat_mask = torch.cat([mask] * len(names), dim=1)
        moe_loss = 0.0
        for i in range(self.cfg.num_cross_encoder_layers):
            z = getattr(self, f"layer_{i}")(z, cat_mask, deterministic, generator)
            if self.use_moe:
                z, aux = self.moe(i)(z, cat_mask, deterministic, generator)
                moe_loss = moe_loss + aux
        K = mask.shape[1]
        outs = {m: z[:, i * K:(i + 1) * K] for i, m in enumerate(names)}
        return outs, (moe_loss if self.use_moe else None)


class CoAttentionEncoder(_CrossEncoder):
    """"ca": each modality cross-attends to the feature-axis concat of the
    other modalities."""

    def __init__(self, cfg: MultimodalConfig, use_moe: bool = False, generator=None):
        super().__init__(cfg, use_moe, generator)
        H = cfg.hidden_size
        names = cfg.modalities
        for i in range(cfg.num_cross_encoder_layers):
            for m in names:
                self.add_module(f"{m}_layer_{i}", CrossAttentionLayer(
                    cfg, H, H * (len(names) - 1), generator))

    def forward(self, feats, mask, deterministic: bool = True, generator=None):
        names = _present(feats)
        cur = dict(feats)
        moe_loss = 0.0
        for i in range(self.cfg.num_cross_encoder_layers):
            new = {}
            for m in names:
                others = [cur[o] for o in names if o != m]
                kv = torch.cat(others, dim=-1) if len(others) > 1 else others[0]
                new[m] = getattr(self, f"{m}_layer_{i}")(cur[m], kv, mask, deterministic,
                                                        generator)
            cur = new
            if self.use_moe:
                cur, aux = self.seq_moe(i, cur, names, mask, deterministic, generator)
                moe_loss = moe_loss + aux
        return cur, (moe_loss if self.use_moe else None)


def fuse_features(cfg: MultimodalConfig, feats: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The reference BasePredictor.fuse_features semantics."""
    names = _present(feats)
    if len(names) == 1:
        return feats[names[0]]
    if cfg.fuse_type.startswith("cat"):
        return torch.cat([feats[m] for m in names], dim=-1)
    stack = torch.stack([feats[m] for m in names], dim=0)
    if cfg.fuse_type == "mean":
        return torch.mean(stack, dim=0)
    if cfg.fuse_type == "max":
        return torch.max(stack, dim=0).values
    raise ValueError(cfg.fuse_type)


# ---------------------------------------------------------------- predictors


class LinearPredictor(nn.Module):
    """Linear head; for a cat fuse it can also split the classifier into each
    modality's additive logit contribution (reference: linear_predictor.py:
    14-35: kernel chunked per modality, bias split evenly)."""

    def __init__(self, cfg: MultimodalConfig, generator=None):
        super().__init__()
        self.cfg = cfg
        self.classifier = Dense(cfg.fused_width, cfg.num_labels, generator)

    def forward(self, fused, return_modal: bool = False):
        logits = self.classifier(fused)
        if not return_modal:
            return logits
        M = len(self.cfg.modalities)
        h = fused.shape[-1] // M
        bias = self.classifier(torch.zeros_like(fused))  # the bias term alone
        modal = []
        for i in range(M):
            sel = torch.zeros(fused.shape[-1], dtype=fused.dtype, device=fused.device)
            sel[i * h:(i + 1) * h] = 1.0
            modal.append(self.classifier(fused * sel) - bias + bias / M)
        return logits, modal


class TransformerPredictor(nn.Module):
    def __init__(self, cfg: MultimodalConfig, num_layers: int = 2, generator=None):
        super().__init__()
        self.num_layers = num_layers
        H = cfg.hidden_size
        self.in_proj = Dense(cfg.fused_width, H, generator)
        for i in range(num_layers):
            self.add_module(f"layer_{i}", DenseSelfAttentionLayer(cfg, H, generator))
        self.classifier = Dense(H, cfg.num_labels, generator)

    def forward(self, fused, mask=None):
        if mask is None:
            mask = torch.ones(fused.shape[:2], dtype=torch.int32, device=fused.device)
        x = self.in_proj(fused)
        for i in range(self.num_layers):
            # JAX calls these layers without ``deterministic``: never dropout
            x = getattr(self, f"layer_{i}")(x, mask, deterministic=True)
        return self.classifier(x)


class HybridPredictor(nn.Module):
    """The fused (mm) classifier and one per modality, combined with learned
    weights (reference: hybrid_predictor.py:9-60): scalar parameters
    softmaxed across the streams ("p", initial 0.5 / 0.3 / 0.2 / 0.1) or a
    per-clip linear gate over tanh-projected modality features ("l"), then
    mean- or max-pooled across the weighted streams."""

    def __init__(self, cfg: MultimodalConfig, generator=None):
        super().__init__()
        self.cfg = cfg
        H, C = cfg.hidden_size, cfg.num_labels
        names = cfg.modalities
        self.mm_classifier = Dense(cfg.fused_width, C, generator)
        for m in names:
            self.add_module(f"{m}_classifier", Dense(H, C, generator))
        S = 1 + len(names)
        if cfg.predictor_hybrid_weight_type == "l":
            for m in names:
                self.add_module(f"{m}_gate", Dense(H, H, generator))
            self.gate_classifier = Dense(H * len(names), S, generator)
        else:
            self.modal_weights = nn.Parameter(torch.tensor((0.5, 0.3, 0.2, 0.1)[:S]))

    def forward(self, feats, fused):
        c = self.cfg
        names = _present(feats)
        streams = [self.mm_classifier(fused)]
        streams += [getattr(self, f"{m}_classifier")(feats[m]) for m in names]
        S = len(streams)
        if c.predictor_hybrid_weight_type == "l":
            gates = torch.cat([torch.tanh(getattr(self, f"{m}_gate")(feats[m])) for m in names],
                              dim=-1)
            weights = F.softmax(self.gate_classifier(gates), dim=-1)
        else:
            weights = F.softmax(self.modal_weights, dim=-1).expand(
                *fused.shape[:-1], S).to(fused.dtype)
        weighted = torch.stack(streams, dim=-1) * weights[..., None, :]  # (B, K, C, S)
        if c.predictor_hybrid_pooling == "max":
            return torch.max(weighted, dim=-1).values
        if c.predictor_hybrid_pooling == "mean":
            return torch.mean(weighted, dim=-1)
        raise ValueError(c.predictor_hybrid_pooling)


# -------------------------------------------------------------------- model


class LinearProjector(nn.Module):
    """Per-modality Dense + LayerNorm + Dropout to the common width
    (reference: linear_projector.py:4-30)."""

    def __init__(self, cfg: MultimodalConfig, in_width: int, generator=None):
        super().__init__()
        self.cfg = cfg
        self.proj = Dense(in_width, cfg.hidden_size, generator)
        self.ln = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)

    def forward(self, x, clip_mask=None, deterministic: bool = True, generator=None):
        x = self.ln(self.proj(x))
        return dropout(x, self.cfg.hidden_dropout, not deterministic, generator)


class TransformerProjector(LinearProjector):
    """Per-modality projection through a small transformer encoder
    (reference: projector/transformer_projector.py:8-62): Linear + LN +
    Dropout into the width, then post-LN layers with an optional residual
    skip."""

    def __init__(self, cfg: MultimodalConfig, in_width: int, generator=None):
        super().__init__(cfg, in_width, generator)
        for i in range(cfg.proj_num_layers):
            self.add_module(f"layer_{i}", DenseSelfAttentionLayer(cfg, cfg.hidden_size,
                                                                  generator))
        if cfg.proj_skip:
            self.skip_ln = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)

    def forward(self, x, clip_mask=None, deterministic: bool = True, generator=None):
        x = super().forward(x, None, deterministic, generator)
        residual = x
        for i in range(self.cfg.proj_num_layers):
            x = getattr(self, f"layer_{i}")(x, clip_mask, deterministic, generator)
        if self.cfg.proj_skip:
            x = self.skip_ln(x + residual)
        return x


class MultiModalForTS(nn.Module):
    """Projector -> cross-encoder -> predictor over clip-aligned features.
    The text clip features are gathered from the text encoder at BOS
    positions upstream (projects/mmvts.py); vis / audio features come from
    the cached per-clip extractors."""

    def __init__(self, cfg: MultimodalConfig, dtype: torch.dtype = torch.float32,
                 generator=None):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        projector = TransformerProjector if cfg.projector_type == "transformer" else (
            LinearProjector)
        for m in cfg.modalities:
            self.add_module(f"{m}_projector", projector(cfg, cfg.input_width(m), generator))
        self.cross_encoder = None
        if len(cfg.modalities) > 1 and cfg.cross_encoder_type != "none":
            use_moe = "moe" in cfg.cross_encoder_type
            if cfg.cross_encoder_type.startswith("ma"):
                self.cross_encoder = MergeAttentionEncoder(cfg, use_moe, generator)
            elif cfg.cross_encoder_type.startswith("ca"):
                self.cross_encoder = CoAttentionEncoder(cfg, use_moe, generator)
            else:
                raise ValueError(cfg.cross_encoder_type)
        if cfg.predictor_type == "linear":
            self.predictor = LinearPredictor(cfg, generator)
        elif cfg.predictor_type == "transformer":
            self.predictor = TransformerPredictor(cfg, generator=generator)
        elif cfg.predictor_type == "hybrid":
            self.predictor = HybridPredictor(cfg, generator)
        else:
            raise ValueError(cfg.predictor_type)

    def forward(self, clip_mask, text_feats=None, vis_feats=None, audio_feats=None,
                generator: Optional[torch.Generator] = None):
        c = self.cfg
        deterministic = not self.training
        raw = {"text": text_feats, "vis": vis_feats, "audio": audio_feats}
        feats: Dict[str, torch.Tensor] = {}
        for m in c.modalities:
            if raw[m] is None:
                raise ValueError(f"modality {m} required by fuse_type {c.fuse_type}")
            feats[m] = getattr(self, f"{m}_projector")(raw[m].to(self.dtype), clip_mask,
                                                       deterministic, generator)
        projected = dict(feats)
        moe_loss = None
        if self.cross_encoder is not None:
            feats, moe_loss = self.cross_encoder(feats, clip_mask, deterministic, generator)
        fused = fuse_features(c, feats)
        modal_logits = None
        if c.predictor_type == "linear":
            split_modal = c.out_modal_prob and c.fuse_type.startswith("cat")
            out = self.predictor(fused, return_modal=split_modal)
            logits, modal_logits = out if split_modal else (out, None)
        elif c.predictor_type == "transformer":
            logits = self.predictor(fused, clip_mask)
        else:
            logits = self.predictor(feats, fused)
        return {
            "logits": logits,  # (B, K, num_labels)
            "modal_logits": modal_logits,  # out_modal_prob: per-modality splits
            "fused": fused,
            "features": feats,
            "projected": projected,
            "moe_loss": moe_loss,
        }
