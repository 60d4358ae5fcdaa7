"""Transformer encoder trunk (dense attention), PyTorch.

Counterpart of ``spokennlp_tpu/models/encoder.py`` for ``attention_type=
"dense"``: BERT, and ELECTRA through its embedding projection. Parameter
names and shapes follow the Flax tree (``qkv.kernel`` (H, 3, nh, hd),
``out.kernel`` (nh, hd, H), ``mlp_in.kernel`` (H, I), LayerNorms with
``scale`` and ``bias``), so a JAX checkpoint maps one-to-one onto the
``state_dict`` (models/convert.py).

Parameters stay float32; ``dtype`` is the compute dtype, as in the Flax
modules. ``module.training`` plays the part of JAX's ``deterministic=False``:
dropout (hidden states, attention probabilities) is applied only in training
mode, with masks drawn from the ``generator`` given to ``forward``.

Three attention paths, resolved by ``attention_impl``:

- ``"einsum"``: plain PyTorch, with exact-erf GELU;
- ``"fused"`` (inference): per layer, the fused attention block and the
  fused MLP block (ops/cuda/), whose GELU is the tanh form, as on the TPU;
  in training mode it means ``"train_fused"``;
- ``"train_fused"``: per layer, the training attention block (probability
  dropout inside the kernel) and the training MLP core
  (ops/cuda/train_blocks.py), each with a backward kernel; residual,
  LayerNorm and hidden-state dropout stay in PyTorch.

``"auto"`` picks ``"train_fused"`` for CUDA inputs in training mode,
``"fused"`` for CUDA inputs in eval mode without ``output_attentions``, and
``"einsum"`` anywhere else.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from spokennlp_tpu_torch.configs import EncoderConfig
from spokennlp_tpu_torch.ops.cuda.attention_block import fused_attention_block
from spokennlp_tpu_torch.ops.cuda.mlp_block import fused_mlp_block
from spokennlp_tpu_torch.ops.cuda.train_blocks import attention_block_train, mlp_block_train

ACT2FN = {
    # HF semantics: "gelu" is the exact erf form; the fused MLP kernel uses
    # the tanh form (ops/cuda/int8_matmul.py ACTIVATIONS)
    "gelu": lambda x: F.gelu(x, approximate="none"),
    "gelu_new": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
    "silu": F.silu,
}

NEG_INF = -1e9


@dataclasses.dataclass
class EncoderOutput:
    last_hidden_state: torch.Tensor  # (B, L, H)
    pooled_output: Optional[torch.Tensor] = None  # (B, H) tanh(W @ h_cls)
    hidden_states: Optional[tuple] = None  # per layer (B, L, H), embeddings first
    attentions: Optional[tuple] = None  # per layer (B, nh, L, L), einsum path only


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Flax ``nn.Dropout``: keep with probability 1 - rate and scale kept
    values by 1 / (1 - rate), in x's dtype; the identity outside training.
    The mask comes from ``generator`` (the default one when None)."""
    if not training or rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), 0.0).to(x.dtype)


def _lecun_normal_(t: torch.Tensor, fan_in: int, generator: Optional[torch.Generator]):
    std = 1.0 / math.sqrt(fan_in)
    nn.init.trunc_normal_(t, std=std, a=-2.0 * std, b=2.0 * std, generator=generator)


class Dense(nn.Module):
    """Flax ``nn.Dense``: ``kernel`` (in, out) and ``bias`` (out,)."""

    def __init__(self, in_features: int, features: int, generator=None):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(in_features, features))
        self.bias = nn.Parameter(torch.zeros(features))
        _lecun_normal_(self.kernel.data, in_features, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.kernel.to(x.dtype) + self.bias.to(x.dtype)


class LayerNorm(nn.Module):
    """Flax ``nn.LayerNorm``: ``scale`` and ``bias``; statistics in float32."""

    def __init__(self, features: int, eps: float):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), x.shape[-1:], self.scale, self.bias, self.eps)
        return y.to(x.dtype)


class Embed(nn.Module):
    """Flax ``nn.Embed``: ``embedding`` (num, features)."""

    def __init__(self, num: int, features: int, generator=None):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(num, features))
        nn.init.normal_(self.embedding.data, std=0.02, generator=generator)

    def forward(self, ids: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return F.embedding(ids, self.embedding).to(dtype)


class Embeddings(nn.Module):
    """Word + absolute-position + token-type embeddings, LayerNorm, and
    ELECTRA's projection to the trunk width when ``embedding_size`` differs."""

    def __init__(self, cfg: EncoderConfig, dtype: torch.dtype, generator=None):
        super().__init__()
        if cfg.position_style != "bert":
            raise NotImplementedError(f"position_style={cfg.position_style!r} is not ported yet")
        self.dtype = dtype
        E = cfg.embedding_size or cfg.hidden_size
        self.word_embeddings = Embed(cfg.vocab_size, E, generator)
        self.position_embeddings = Embed(cfg.max_position_embeddings, E, generator)
        self.token_type_embeddings = (
            Embed(cfg.type_vocab_size, E, generator) if cfg.type_vocab_size > 0 else None
        )
        self.LayerNorm = LayerNorm(E, cfg.layer_norm_eps)
        self.embeddings_project = (
            Dense(E, cfg.hidden_size, generator) if E != cfg.hidden_size else None
        )
        self.dropout_rate = cfg.hidden_dropout

    def forward(self, input_ids, token_type_ids=None, position_ids=None, generator=None):
        L = input_ids.shape[1]
        if position_ids is None:
            position_ids = torch.arange(L, device=input_ids.device)[None, :]
        x = self.word_embeddings(input_ids, self.dtype) + self.position_embeddings(
            position_ids, self.dtype
        )
        if self.token_type_embeddings is not None:
            if token_type_ids is None:
                token_type_ids = torch.zeros_like(input_ids)
            x = x + self.token_type_embeddings(token_type_ids, self.dtype)
        x = self.LayerNorm(x)
        x = dropout(x, self.dropout_rate, self.training, generator)
        if self.embeddings_project is not None:
            x = self.embeddings_project(x)
        return x


class FusedQKV(nn.Module):
    """Fused QKV projection: ``kernel`` (H, 3, nh, hd), ``bias`` (3, nh, hd)."""

    def __init__(self, hidden: int, num_heads: int, head_dim: int, generator=None):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(hidden, 3, num_heads, head_dim))
        self.bias = nn.Parameter(torch.zeros(3, num_heads, head_dim))
        _lecun_normal_(self.kernel.data, hidden, generator)

    def forward(self, hidden: torch.Tensor) -> torch.Tensor:  # -> (B, L, 3, nh, hd)
        dt = hidden.dtype
        return torch.einsum("blh,hsnd->blsnd", hidden, self.kernel.to(dt)) + self.bias.to(dt)


class AttnOutProj(nn.Module):
    """Output projection: ``kernel`` (nh, hd, H), ``bias`` (H,)."""

    def __init__(self, num_heads: int, head_dim: int, features: int, generator=None):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(num_heads, head_dim, features))
        self.bias = nn.Parameter(torch.zeros(features))
        _lecun_normal_(self.kernel.data, num_heads * head_dim, generator)

    def forward(self, ctx: torch.Tensor) -> torch.Tensor:  # (B, L, nh, hd) -> (B, L, H)
        dt = ctx.dtype
        return torch.einsum("blnd,ndh->blh", ctx, self.kernel.to(dt)) + self.bias.to(dt)


class SelfAttention(nn.Module):
    """Multi-head self-attention with a fused QKV projection (einsum path);
    the fused path reads ``qkv`` and ``out`` directly (TransformerLayer)."""

    def __init__(self, cfg: EncoderConfig, generator=None):
        super().__init__()
        self.cfg = cfg
        self.qkv = FusedQKV(cfg.hidden_size, cfg.num_heads, cfg.head_dim, generator)
        self.out = AttnOutProj(cfg.num_heads, cfg.head_dim, cfg.hidden_size, generator)

    def forward(self, hidden, attention_bias, output_attentions=False, generator=None):
        dt = hidden.dtype
        q, k, v = self.qkv(hidden).unbind(2)  # (B, L, nh, hd)
        scale = 1.0 / math.sqrt(self.cfg.head_dim)
        scores = torch.einsum("blhd,bmhd->bhlm", q * scale, k)
        if attention_bias is not None:
            scores = scores + attention_bias.to(scores.dtype)
        sm_dtype = dt if self.cfg.softmax_in_compute_dtype else torch.float32
        probs = torch.softmax(scores.to(sm_dtype), dim=-1).to(dt)
        probs = dropout(probs, self.cfg.attention_dropout, self.training, generator)
        ctx = torch.einsum("bhlm,bmhd->blhd", probs, v)
        return self.out(ctx), (probs if output_attentions else None)


class TransformerLayer(nn.Module):
    """Post-LayerNorm transformer block (BERT convention)."""

    def __init__(self, cfg: EncoderConfig, generator=None):
        super().__init__()
        self.cfg = cfg
        H, I = cfg.hidden_size, cfg.intermediate_size
        self.attention = SelfAttention(cfg, generator)
        self.attention_ln = LayerNorm(H, cfg.layer_norm_eps)
        self.mlp_in = Dense(H, I, generator)
        self.mlp_out = Dense(I, H, generator)
        self.mlp_ln = LayerNorm(H, cfg.layer_norm_eps)

    def forward(self, hidden, attention_bias, output_attentions=False, generator=None):
        rate = self.cfg.hidden_dropout
        attn_out, probs = self.attention(hidden, attention_bias, output_attentions, generator)
        attn_out = dropout(attn_out, rate, self.training, generator)
        hidden = self.attention_ln(hidden + attn_out)
        mlp = self.mlp_out(ACT2FN[self.cfg.hidden_act](self.mlp_in(hidden)))
        mlp = dropout(mlp, rate, self.training, generator)
        return self.mlp_ln(hidden + mlp), probs

    def forward_fused(self, hidden, segment_ids):
        """h1 = LN(x + attn(x)) in the attention-block kernel, then
        h2 = LN(h1 + mlp(h1)) in the MLP-block kernel."""
        cfg = self.cfg
        B, L, H = hidden.shape
        attn, ln1 = self.attention, self.attention_ln
        h1 = fused_attention_block(
            hidden, segment_ids, attn.qkv.kernel, attn.qkv.bias, attn.out.kernel,
            attn.out.bias, sm_scale=1.0 / math.sqrt(cfg.head_dim),
            ln_scale=ln1.scale, ln_bias=ln1.bias, eps=cfg.layer_norm_eps,
        )
        out = fused_mlp_block(
            h1.reshape(B * L, H), self.mlp_in.kernel, self.mlp_in.bias,
            self.mlp_out.kernel, self.mlp_out.bias, self.mlp_ln.scale, self.mlp_ln.bias,
            activation=cfg.hidden_act, eps=cfg.layer_norm_eps, quantized=False,
        )
        return out.reshape(B, L, H)

    def forward_train_fused(self, hidden, segment_ids, generator=None):
        """The training kernels: attn = attention block (probability dropout
        inside the kernel, seeded from ``generator``), h1 = LN(x +
        dropout(attn)); mlp = the MLP core, h2 = LN(h1 + dropout(mlp))."""
        cfg = self.cfg
        B, L, H = hidden.shape
        attn = self.attention
        rate = cfg.attention_dropout if self.training else 0.0
        seed = torch.zeros(1, dtype=torch.int32, device=hidden.device)
        if rate > 0.0:
            seed = torch.randint(0, 2**31 - 1, (1,), generator=generator, device=hidden.device,
                                 dtype=torch.int32)
        attn_out = attention_block_train(
            hidden, segment_ids, attn.qkv.kernel, attn.qkv.bias, attn.out.kernel, attn.out.bias,
            seed, sm_scale=1.0 / math.sqrt(cfg.head_dim), dropout_rate=rate,
        )
        attn_out = dropout(attn_out, cfg.hidden_dropout, self.training, generator)
        hidden = self.attention_ln(hidden + attn_out)
        mlp = mlp_block_train(
            hidden.reshape(B * L, H), self.mlp_in.kernel, self.mlp_in.bias, self.mlp_out.kernel,
            self.mlp_out.bias, activation=cfg.hidden_act,
        ).reshape(B, L, H)
        mlp = dropout(mlp, cfg.hidden_dropout, self.training, generator)
        return self.mlp_ln(hidden + mlp)


def resolve_attention_impl(
    cfg: EncoderConfig, device: torch.device, output_attentions: bool, training: bool = False
) -> str:
    """"einsum", "fused" or "train_fused", as the encoder will run; raises
    for what the port does not have yet. In training mode "fused" means the
    training kernels: the inference kernels have no backward and skip
    dropout."""
    if cfg.attention_type != "dense":
        raise NotImplementedError(f"attention_type={cfg.attention_type!r} is not ported yet")
    if cfg.quantize == "w8a8":
        raise NotImplementedError("quantize='w8a8' is not ported yet")
    impl = cfg.attention_impl
    if impl == "auto":
        if device.type != "cuda":
            impl = "einsum"
        else:
            impl = "train_fused" if training else "fused"
    if impl not in ("einsum", "fused", "train_fused"):
        raise NotImplementedError(f"attention_impl={impl!r} is not ported yet")
    if impl == "fused" and training:
        impl = "train_fused"
    # the fused kernels return no attention probabilities
    return "einsum" if output_attentions else impl


class Encoder(nn.Module):
    """The trunk: embeddings, N transformer layers, optional pooler."""

    def __init__(
        self,
        cfg: EncoderConfig,
        dtype: torch.dtype = torch.float32,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.embeddings = Embeddings(cfg, dtype, generator)
        for i in range(cfg.num_layers):
            self.add_module(f"layer_{i}", TransformerLayer(cfg, generator))
        self.pooler = (
            Dense(cfg.hidden_size, cfg.hidden_size, generator) if cfg.add_pooler else None
        )

    def layers(self):
        return [getattr(self, f"layer_{i}") for i in range(self.cfg.num_layers)]

    def forward(
        self,
        input_ids: torch.Tensor,
        attention_mask: Optional[torch.Tensor] = None,
        token_type_ids: Optional[torch.Tensor] = None,
        position_ids: Optional[torch.Tensor] = None,
        pack_segment_ids: Optional[torch.Tensor] = None,
        output_hidden_states: bool = False,
        output_attentions: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> EncoderOutput:
        """``pack_segment_ids`` (B, L): 0 on pad tokens, i + 1 on packed
        window i; tokens attend only within their window. ``generator``
        draws the dropout masks and kernel seeds in training mode."""
        B, L = input_ids.shape
        if attention_mask is None:
            attention_mask = torch.ones((B, L), dtype=torch.int32, device=input_ids.device)
        impl = resolve_attention_impl(self.cfg, input_ids.device, output_attentions,
                                      self.training)

        hidden = self.embeddings(input_ids, token_type_ids, position_ids, generator)
        all_hidden = (hidden,) if output_hidden_states else None
        all_attn = () if output_attentions else None
        if impl in ("fused", "train_fused"):
            seg = pack_segment_ids if pack_segment_ids is not None else attention_mask
            seg = seg.to(torch.int32)
            for layer in self.layers():
                if impl == "fused":
                    hidden = layer.forward_fused(hidden, seg)
                else:
                    hidden = layer.forward_train_fused(hidden, seg, generator)
                if output_hidden_states:
                    all_hidden = all_hidden + (hidden,)
        else:
            bias = (1.0 - attention_mask[:, None, None, :].float()) * NEG_INF
            if pack_segment_ids is not None:
                same = pack_segment_ids[:, :, None] == pack_segment_ids[:, None, :]
                bias = bias + torch.where(same, 0.0, NEG_INF)[:, None, :, :]
            for layer in self.layers():
                hidden, probs = layer(hidden, bias, output_attentions, generator)
                if output_hidden_states:
                    all_hidden = all_hidden + (hidden,)
                if output_attentions:
                    all_attn = all_attn + (probs,)

        pooled = torch.tanh(self.pooler(hidden[:, 0])) if self.pooler is not None else None
        return EncoderOutput(
            last_hidden_state=hidden,
            pooled_output=pooled,
            hidden_states=all_hidden,
            attentions=all_attn,
        )
