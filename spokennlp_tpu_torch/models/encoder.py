"""Transformer encoder trunk, PyTorch: dense attention, Longformer's
sliding window with global tokens, and BigBird's block-sparse attention.

Counterpart of ``spokennlp_tpu/models/encoder.py`` for ``attention_type=
"dense"`` (BERT, and ELECTRA through its embedding projection),
``"sliding_window"`` (Longformer, with RoBERTa positions) and ``"bigbird"``
(BigBird ITC, with BERT's parameter layout). Parameter
names and shapes follow the Flax tree (``qkv.kernel`` (H, 3, nh, hd),
``out.kernel`` (nh, hd, H), ``mlp_in.kernel`` (H, I), LayerNorms with
``scale`` and ``bias``), so a JAX checkpoint maps one-to-one onto the
``state_dict`` (models/convert.py).

Parameters stay float32; ``dtype`` is the compute dtype, as in the Flax
modules. ``module.training`` plays the part of JAX's ``deterministic=False``:
dropout (hidden states, attention probabilities) is applied only in training
mode, with masks drawn from the ``generator`` given to ``forward``.

Attention paths, resolved by ``attention_impl`` (``resolve_attention_impl``):

- ``"einsum"``: plain PyTorch, with exact-erf GELU;
- ``"fused"`` (inference): per layer, the fused attention block and the
  fused MLP block (ops/cuda/), whose GELU is the tanh form, as on the TPU;
  in training mode it means ``"train_fused"``;
- ``"stack"`` (inference): every layer in one launch of the whole-stack
  kernel (ops/cuda/stack_block.py); no per-layer hidden states;
- ``"pallas"``: the einsum path's projections around the attention kernel
  over a projected (B, 3, nh, L, hd) qkv (ops/cuda/blhd_attention.py);
- ``"flash"``: no kernel of its own (JAX's is its library's TPU kernel):
  ``"pallas"`` at inference and ``"train_fused"`` in training on the card,
  ``"einsum"`` elsewhere (``_resolve_flash``);
- ``"train_fused"``: per layer, the training attention block (probability
  dropout inside the kernel) and the training MLP core
  (ops/cuda/train_blocks.py), each with a backward kernel; residual,
  LayerNorm and hidden-state dropout stay in PyTorch.

``"auto"`` picks, as the JAX encoder does on its accelerator:
``"train_fused"`` for CUDA inputs in training mode; for CUDA inputs in eval
mode without ``output_attentions``, ``"stack"`` for batches of 32 or fewer
without ``output_hidden_states`` and ``"fused"`` otherwise; ``"einsum"``
anywhere else.

``quantize="w8a8"`` (inference only: training ignores it, as rounding has
no gradient) runs the projections int8 x int8 -> int32 where JAX does: the
W8A8 modes of the fused and stack kernels, and on the einsum path every
projection through ``quant_dense`` (ops/cuda/int8_matmul.py) with the MLP's
activation (the tanh GELU) in ``mlp_in``'s epilogue. The ``"pallas"`` path
keeps its two attention projections unquantised and quantises the MLP, as
JAX's layouts there do.

Sliding-window models have the same three, with the Longformer kernels
(ops/cuda/sliding_block.py, ops/cuda/train_sliding.py) in the attention half
and the same MLP kernels; their einsum path is ``sliding_window_impl``'s
``"bias"`` (an (L, L) mask, with the dense global pass) or ``"chunked"``
(the banded pass of ops/sliding_attention.py and an O(G L) global pass),
``"auto"`` picking chunked above 1024 tokens. The kernels need the
contract of the TPU kernels: L a multiple of C = window // 2, C of 8, and a
promise (``prefix_globals``) that padding is a suffix and the global tokens
a prefix of at most ``max_global_tokens``. On CUDA a broken contract raises;
on the CPU the encoder takes the einsum path, as the JAX encoder does off
the TPU.

BigBird models likewise, with the BigBird kernels (ops/cuda/bigbird_block.py,
ops/cuda/train_bigbird.py) in the attention half; their einsum path is
``bigbird_impl``'s ``"bias"`` (the (L, L) mask through the dense branch,
probability dropout included) or ``"block"`` (the gather path of
ops/bigbird_attention.py, which drops out no probabilities, as in JAX),
``"auto"`` picking block above 1024 tokens. The kernels need L a multiple of
``bigbird_block_size``, that of 8, and the suffix-padding promise
(``prefix_globals``, 0 for BigBird: its globals are the first blocks); in
training they run whatever ``bigbird_impl`` says, as in JAX.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from spokennlp_tpu_torch.configs import EncoderConfig
from spokennlp_tpu_torch.ops.bigbird_attention import (
    bigbird_attention_bias, bigbird_block_sparse_attention,
)
from spokennlp_tpu_torch.ops.cuda.attention_block import fused_attention_block
from spokennlp_tpu_torch.ops.cuda.bigbird_block import fused_bigbird_attention_block
from spokennlp_tpu_torch.ops.cuda.blhd_attention import snld_self_attention
from spokennlp_tpu_torch.ops.cuda.int8_matmul import quant_dense
from spokennlp_tpu_torch.ops.cuda.mlp_block import fused_mlp_block
from spokennlp_tpu_torch.ops.cuda.sliding_block import fused_sliding_attention_block
from spokennlp_tpu_torch.ops.cuda.stack_block import fused_encoder_stack
from spokennlp_tpu_torch.ops.cuda.train_bigbird import bigbird_attention_block_train
from spokennlp_tpu_torch.ops.cuda.train_blocks import attention_block_train, mlp_block_train
from spokennlp_tpu_torch.ops.cuda.train_sliding import sliding_attention_block_train
from spokennlp_tpu_torch.ops.sliding_attention import (
    chunked_sliding_window_attention, global_key_index, sliding_window_attention_mask_bias,
)
from spokennlp_tpu_torch.parallel.dist import draw_rand, rank_seed
from spokennlp_tpu_torch.parallel.mesh import shard_axis, whole

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
class SlidingMasks:
    """What a sliding-window layer reads besides the hidden states: the
    (B, L) attention and global masks, the key-padding bias of the global
    pass (B, 1, 1, L), the plain path (``chunked`` or not) and, for the
    kernels, whether any row is global."""

    attention_mask: torch.Tensor
    global_mask: Optional[torch.Tensor]
    key_padding_bias: torch.Tensor
    chunked: bool = False
    global_rows: bool = True


@dataclasses.dataclass
class EncoderOutput:
    last_hidden_state: torch.Tensor  # (B, L, H)
    pooled_output: Optional[torch.Tensor] = None  # (B, H) tanh(W @ h_cls)
    hidden_states: Optional[tuple] = None  # per layer (B, L, H), embeddings first
    attentions: Optional[tuple] = None  # per layer (B, nh, L, L), einsum path only


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: Optional[torch.Generator], heads: Optional[tuple] = None) -> torch.Tensor:
    """Flax ``nn.Dropout``: keep with probability 1 - rate and scale kept
    values by 1 / (1 - rate), in x's dtype; the identity outside training.
    The mask comes from ``generator`` (the default one when None), drawn
    over the global batch under ``dist.sharded_batch``; ``heads`` (start,
    stop, count, ...): x holds those heads of axis 1, and the mask is drawn
    for every head and cut to them (a model rank's share of the
    probabilities)."""
    if not training or rate == 0.0:
        return x
    shape = x.shape if heads is None else (x.shape[0], heads[2], *x.shape[2:])
    keep = draw_rand(shape, generator, x.device)
    if heads is not None:
        keep = keep[:, heads[0]:heads[1]]
    return torch.where(keep >= rate, x / (1.0 - rate), 0.0).to(x.dtype)


# the std of a standard normal truncated to [-2, 2]: Flax's truncated normal
# divides by it so that the truncated draw keeps the variance asked for
_TRUNC_STD = 0.87962566103423978


def _lecun_normal_(t: torch.Tensor, fan_in: int, generator: Optional[torch.Generator]):
    """Flax's ``lecun_normal`` (variance_scaling(1, "fan_in",
    "truncated_normal")): variance 1 / fan_in, truncated at two of its
    (uncorrected) standard deviations. ``fan_in`` is the product of the
    kernel's input axes (FusedQKV: H; AttnOutProj: nh * hd)."""
    std = 1.0 / math.sqrt(fan_in) / _TRUNC_STD
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
    """Flax ``nn.Embed``: ``embedding`` (num, features), drawn as Flax draws
    it (variance_scaling(1, "fan_in", "normal", out_axis=0): the fan-in of a
    (num, features) table is ``features``, so N(0, 1 / features))."""

    def __init__(self, num: int, features: int, generator=None):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(num, features))
        nn.init.normal_(self.embedding.data, std=1.0 / math.sqrt(features), generator=generator)

    def forward(self, ids: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return lookup(self.embedding, ids).to(dtype)


ONE_HOT_ROWS = 4096
"""Tables of at most this many rows (token types, positions) take their
gradient as a one-hot product; larger ones (vocabularies) as a sorted
segment sum."""


def table_grad(ids: torch.Tensor, g: torch.Tensor, num: int) -> torch.Tensor:
    """The gradient of ``table[ids]`` for a table of ``num`` rows, the rows
    of each id summed in an order fixed by the data: a float32 one-hot
    product for small tables, else the rows sorted by id (stable) and each
    id's run summed in order (``segment_reduce``), written once per id.
    PyTorch's CUDA embedding backward adds repeated ids with atomics, in an
    order that changes from run to run."""
    ids = ids.reshape(-1).long()
    g = g.reshape(ids.numel(), -1).float()
    if num <= ONE_HOT_ROWS:
        return F.one_hot(ids, num).float().T @ g
    order = torch.argsort(ids, stable=True)
    uniq, counts = torch.unique_consecutive(ids[order], return_counts=True)
    sums = torch.segment_reduce(g[order], "sum", lengths=counts, axis=0)
    return g.new_zeros(num, g.shape[1]).index_copy_(0, uniq, sums)


class _Lookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.num = table.shape[0]
        return F.embedding(ids, table)

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        return table_grad(ids, g, ctx.num).to(g.dtype), None


def lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``F.embedding(ids, table)`` with the deterministic backward
    (``table_grad``): the same gradient, the same bits on every run."""
    return _Lookup.apply(table, ids)


class Embeddings(nn.Module):
    """Word + absolute-position + token-type embeddings, LayerNorm, and
    ELECTRA's projection to the trunk width when ``embedding_size`` differs.
    Positions are ``arange(L)`` ("bert") or RoBERTa's: the running count of
    non-pad tokens on non-pad tokens, offset by the pad id ("roberta")."""

    def __init__(self, cfg: EncoderConfig, dtype: torch.dtype, generator=None):
        super().__init__()
        if cfg.position_style not in ("bert", "roberta"):
            raise NotImplementedError(f"position_style={cfg.position_style!r} is not ported yet")
        self.position_style, self.pad_token_id = cfg.position_style, cfg.pad_token_id
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
        if position_ids is None and self.position_style == "roberta":
            not_pad = (input_ids != self.pad_token_id).long()
            position_ids = torch.cumsum(not_pad, dim=1) * not_pad + self.pad_token_id
        elif position_ids is None:
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
    """Fused QKV projection: ``kernel`` (H, 3, nh, hd), ``bias`` (3, nh, hd).
    ``layout`` "blsnd" gives (B, L, 3, nh, hd), "bsnld" (B, 3, nh, L, hd);
    ``quantize`` runs the "blsnd" projection on the W8A8 path, as JAX's
    ``FusedQKV`` does (and only that layout)."""

    def __init__(self, hidden: int, num_heads: int, head_dim: int, generator=None):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(hidden, 3, num_heads, head_dim))
        self.bias = nn.Parameter(torch.zeros(3, num_heads, head_dim))
        _lecun_normal_(self.kernel.data, hidden, generator)

    def forward(self, hidden: torch.Tensor, quantize: bool = False,
                layout: str = "blsnd", gathered: bool = False,
                heads: Optional[tuple] = None) -> torch.Tensor:
        """``gathered``: a model-sharded kernel gathered whole first (the
        kernels' and W8A8's paths); ``heads`` (start, stop, count, model
        axis): the whole kernel's heads start..stop, their gradient summed
        over the model group (a whole projection feeding a model rank's
        heads)."""
        dt = hidden.dtype
        kernel, bias = self.kernel, self.bias
        if gathered:
            kernel, bias = whole(kernel), whole(bias)
        if heads is not None:
            ax = heads[3]
            kernel = ax.copy(kernel)[:, :, heads[0]:heads[1]]
            bias = ax.copy(bias)[:, heads[0]:heads[1]]
        if quantize and layout == "blsnd":
            B, L, H = hidden.shape
            out = quant_dense(hidden.reshape(B * L, H), kernel.reshape(H, -1),
                              bias.reshape(-1), out_dtype=dt)
            return out.reshape(B, L, *kernel.shape[1:])
        kernel, bias = kernel.to(dt), bias.to(dt)
        if layout == "blsnd":
            return torch.einsum("blh,hsnd->blsnd", hidden, kernel) + bias
        if layout == "bsnld":
            return torch.einsum("blh,hsnd->bsnld", hidden, kernel) + bias[None, :, :, None, :]
        raise ValueError(layout)


class AttnOutProj(nn.Module):
    """Output projection: ``kernel`` (nh, hd, H), ``bias`` (H,), from ctx in
    layout "blnd" (B, L, nh, hd) or "bnld" (B, nh, L, hd); ``quantize`` runs
    the "blnd" projection on the W8A8 path, as JAX's ``AttnOutProj`` does."""

    def __init__(self, num_heads: int, head_dim: int, features: int, generator=None):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(num_heads, head_dim, features))
        self.bias = nn.Parameter(torch.zeros(features))
        _lecun_normal_(self.kernel.data, num_heads * head_dim, generator)

    def forward(self, ctx: torch.Tensor, quantize: bool = False,
                layout: str = "blnd", gathered: bool = False,
                partial=None) -> torch.Tensor:  # -> (B, L, H)
        """``gathered``: a model-sharded kernel gathered whole first;
        ``partial`` (a model axis): ``ctx`` holds this rank's heads of a
        sharded kernel, and the heads' products are summed over the model
        group before the bias is added once."""
        dt = ctx.dtype
        kernel = whole(self.kernel) if gathered else self.kernel
        if quantize and layout == "blnd":
            B, L, nh, hd = ctx.shape
            out = quant_dense(ctx.reshape(B * L, nh * hd), kernel.reshape(nh * hd, -1),
                              self.bias, out_dtype=dt)
            return out.reshape(B, L, -1)
        if layout not in ("blnd", "bnld"):
            raise ValueError(layout)
        out = torch.einsum(f"{layout},ndh->blh", ctx, kernel.to(dt))
        if partial is not None:
            out = partial.reduce(out)
        return out + self.bias.to(dt)


class SelfAttention(nn.Module):
    """Multi-head self-attention with a fused QKV projection (einsum path);
    the fused paths read ``qkv``, ``qkv_global`` and ``out`` directly
    (TransformerLayer). Sliding-window models have ``qkv_global``, the
    projections of the Longformer global pass."""

    def __init__(self, cfg: EncoderConfig, generator=None):
        super().__init__()
        self.cfg = cfg
        self.qkv = FusedQKV(cfg.hidden_size, cfg.num_heads, cfg.head_dim, generator)
        self.qkv_global = (
            FusedQKV(cfg.hidden_size, cfg.num_heads, cfg.head_dim, generator)
            if cfg.attention_type == "sliding_window" else None
        )
        self.out = AttnOutProj(cfg.num_heads, cfg.head_dim, cfg.hidden_size, generator)

    def forward(self, hidden, attention_bias, output_attentions=False, generator=None,
                sliding: Optional[SlidingMasks] = None, quantized: bool = False,
                segment_ids: Optional[torch.Tensor] = None,
                bigbird: Optional[torch.Tensor] = None):
        """``segment_ids`` (B, L) selects the ``"pallas"`` path: the
        attention kernel over a (B, 3, nh, L, hd) projection, whose two
        projections stay unquantised. ``bigbird`` (the (B, L) attention
        mask) selects BigBird's block path."""
        cfg = self.cfg
        dt = hidden.dtype
        scale = 1.0 / math.sqrt(cfg.head_dim)
        # the model axis: the einsum path computes this rank's heads and sums
        # the out projection over the model group; the kernel (pallas) and
        # W8A8 paths take the weights gathered whole
        ax = shard_axis(self.qkv.kernel)
        gathered = ax is not None and (segment_ids is not None or quantized)
        if segment_ids is not None:
            ctx = snld_self_attention(self.qkv(hidden, layout="bsnld", gathered=gathered),
                                      segment_ids, scale)
            return self.out(ctx, layout="bnld", gathered=gathered), None
        split = None if gathered else ax
        heads = None
        if split is not None:
            hidden = split.copy(hidden)
            n = self.qkv.kernel.shape[2]
            heads = (split.index * n, (split.index + 1) * n, cfg.num_heads, split)
        q, k, v = self.qkv(hidden, quantize=quantized, gathered=gathered).unbind(2)
        sm_dtype = dt if cfg.softmax_in_compute_dtype else torch.float32
        probs = None
        if bigbird is not None:
            ctx = bigbird_block_sparse_attention(
                q, k, v, bigbird, cfg.bigbird_block_size, cfg.bigbird_num_global_blocks,
                cfg.bigbird_num_random_blocks, cfg.bigbird_seed, softmax_dtype=sm_dtype,
            ).to(dt)
        elif sliding is not None and sliding.chunked:
            ctx = chunked_sliding_window_attention(
                q, k, v, sliding.attention_mask, sliding.global_mask, cfg.attention_window,
                max_globals=cfg.max_global_tokens, softmax_dtype=sm_dtype,
            ).to(dt)
        else:
            scores = torch.einsum("blhd,bmhd->bhlm", q * scale, k)
            if attention_bias is not None:
                scores = scores + attention_bias.to(scores.dtype)
            probs = torch.softmax(scores.to(sm_dtype), dim=-1).to(dt)
            probs = dropout(probs, cfg.attention_dropout, self.training, generator, heads)
            ctx = torch.einsum("bhlm,bmhd->blhd", probs, v)
        if sliding is not None and sliding.global_mask is not None:
            ctx = self._global_pass(hidden, ctx, sliding, scale, generator, heads)
        out = self.out(ctx, quantize=quantized, gathered=gathered, partial=split)
        return out, (probs if output_attentions else None)

    def _global_pass(self, hidden, ctx, sliding: SlidingMasks, scale, generator, heads=None):
        """Longformer's global rows: their queries attend to every real key
        through ``qkv_global`` and replace the local rows (O(G L) for the
        first ``max_global_tokens`` global rows on the chunked path).
        ``heads``: a model rank's heads of the whole ``qkv_global``."""
        dt = hidden.dtype
        qg, kg, vg = self.qkv_global(hidden, heads=heads).unbind(2)
        mask, glob = sliding.attention_mask, sliding.global_mask
        if sliding.chunked:
            g_idx, g_valid = global_key_index(mask, glob, self.cfg.max_global_tokens)
            index = g_idx[:, :, None, None].expand(-1, -1, *ctx.shape[2:])
            g_scores = torch.einsum("bghd,bmhd->bhgm", torch.gather(qg, 1, index) * scale, kg)
            g_probs = torch.softmax((g_scores + sliding.key_padding_bias).float(), dim=-1).to(dt)
            g_probs = dropout(g_probs, self.cfg.attention_dropout, self.training, generator,
                              heads)
            rows = torch.einsum("bhgm,bmhd->bghd", g_probs, vg)
            rows = torch.where(g_valid[:, :, None, None], rows, torch.gather(ctx, 1, index))
            return ctx.scatter(1, index, rows)
        g_scores = torch.einsum("blhd,bmhd->bhlm", qg * scale, kg) + sliding.key_padding_bias
        g_probs = torch.softmax(g_scores.float(), dim=-1).to(dt)
        g_probs = dropout(g_probs, self.cfg.attention_dropout, self.training, generator, heads)
        g_ctx = torch.einsum("bhlm,bmhd->blhd", g_probs, vg)
        return torch.where(glob.bool()[:, :, None, None], g_ctx, ctx)


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

    def forward(self, hidden, attention_bias, output_attentions=False, generator=None,
                sliding: Optional[SlidingMasks] = None, quantized: bool = False,
                segment_ids: Optional[torch.Tensor] = None,
                bigbird: Optional[torch.Tensor] = None):
        rate = self.cfg.hidden_dropout
        attn_out, probs = self.attention(hidden, attention_bias, output_attentions, generator,
                                         sliding, quantized, segment_ids, bigbird)
        attn_out = dropout(attn_out, rate, self.training, generator)
        hidden = self.attention_ln(hidden + attn_out)
        if quantized:  # the activation in mlp_in's epilogue, as JAX's QuantDense
            dt = hidden.dtype
            mlp = quant_dense(hidden, whole(self.mlp_in.kernel), whole(self.mlp_in.bias),
                              out_dtype=dt, activation=self.cfg.hidden_act)
            mlp = quant_dense(mlp, whole(self.mlp_out.kernel), self.mlp_out.bias, out_dtype=dt)
        else:
            mlp = sharded_mlp(hidden, self.mlp_in, self.mlp_out, ACT2FN[self.cfg.hidden_act])
        mlp = dropout(mlp, rate, self.training, generator)
        return self.mlp_ln(hidden + mlp), probs

    def _sliding_args(self, sliding: SlidingMasks):
        attn = self.attention
        return (sliding.attention_mask, sliding.global_mask, whole(attn.qkv.kernel),
                whole(attn.qkv.bias), attn.qkv_global.kernel, attn.qkv_global.bias,
                whole(attn.out.kernel), attn.out.bias)

    def _bigbird_pattern(self):
        cfg = self.cfg
        return (cfg.bigbird_block_size, cfg.bigbird_num_global_blocks,
                cfg.bigbird_num_random_blocks, cfg.bigbird_seed)

    def forward_fused(self, hidden, segment_ids, sliding: Optional[SlidingMasks] = None,
                      quantized: bool = False, bigbird: Optional[torch.Tensor] = None):
        """h1 = LN(x + attn(x)) in the attention-block kernel (the dense one,
        the Longformer one with ``sliding``, the BigBird one with ``bigbird``,
        the (B, L) attention mask), then h2 = LN(h1 + mlp(h1)) in the
        MLP-block kernel; ``quantized``: the W8A8 modes of both, for every
        attention type, as JAX passes ``quantized`` to each of its kernels."""
        cfg = self.cfg
        B, L, H = hidden.shape
        attn, ln1 = self.attention, self.attention_ln
        ln = dict(sm_scale=1.0 / math.sqrt(cfg.head_dim), ln_scale=ln1.scale, ln_bias=ln1.bias,
                  eps=cfg.layer_norm_eps, quantized=quantized)
        qkv_k, qkv_b, out_k = whole(attn.qkv.kernel), whole(attn.qkv.bias), whole(attn.out.kernel)
        if bigbird is not None:
            h1 = fused_bigbird_attention_block(hidden, bigbird, qkv_k, qkv_b, out_k,
                                               attn.out.bias, *self._bigbird_pattern(), **ln)
        elif sliding is None:
            h1 = fused_attention_block(hidden, segment_ids, qkv_k, qkv_b, out_k, attn.out.bias,
                                       **ln)
        else:
            h1 = fused_sliding_attention_block(
                hidden, *self._sliding_args(sliding), window=cfg.attention_window,
                max_globals=cfg.max_global_tokens, global_rows=sliding.global_rows, **ln,
            )
        out = fused_mlp_block(
            h1.reshape(B * L, H), whole(self.mlp_in.kernel), whole(self.mlp_in.bias),
            whole(self.mlp_out.kernel), self.mlp_out.bias, self.mlp_ln.scale, self.mlp_ln.bias,
            activation=cfg.hidden_act, eps=cfg.layer_norm_eps, quantized=quantized,
        )
        return out.reshape(B, L, H)

    def stack_params(self):
        """This layer's parameters in the order of the stack kernel
        (ops/cuda/stack_block.py PARAM_NAMES), model-sharded ones gathered
        whole."""
        attn = self.attention
        return tuple(whole(p) for p in (
            attn.qkv.kernel, attn.qkv.bias, attn.out.kernel, attn.out.bias,
            self.attention_ln.scale, self.attention_ln.bias, self.mlp_in.kernel,
            self.mlp_in.bias, self.mlp_out.kernel, self.mlp_out.bias, self.mlp_ln.scale,
            self.mlp_ln.bias))

    def forward_train_fused(self, hidden, segment_ids, generator=None,
                            sliding: Optional[SlidingMasks] = None,
                            bigbird: Optional[torch.Tensor] = None):
        """The training kernels: attn = attention block (probability dropout
        inside the kernel, seeded from ``generator``; the Longformer block
        with ``sliding``, the BigBird one with ``bigbird``), h1 = LN(x +
        dropout(attn)); mlp = the MLP core, h2 = LN(h1 + dropout(mlp))."""
        cfg = self.cfg
        B, L, H = hidden.shape
        attn = self.attention
        rate = cfg.attention_dropout if self.training else 0.0
        seed = torch.zeros(1, dtype=torch.int32, device=hidden.device)
        if rate > 0.0:
            seed = torch.randint(0, 2**31 - 1, (1,), generator=generator, device=hidden.device,
                                 dtype=torch.int32)
            seed = rank_seed(seed).to(torch.int32)
        sm_scale = 1.0 / math.sqrt(cfg.head_dim)
        # the kernels take whole weights: a model-sharded layer gathers them
        qkv_k, qkv_b, out_k = whole(attn.qkv.kernel), whole(attn.qkv.bias), whole(attn.out.kernel)
        if bigbird is not None:
            attn_out = bigbird_attention_block_train(
                hidden, bigbird, qkv_k, qkv_b, out_k, attn.out.bias,
                seed, sm_scale, *self._bigbird_pattern(), dropout_rate=rate,
            )
        elif sliding is None:
            attn_out = attention_block_train(
                hidden, segment_ids, qkv_k, qkv_b, out_k, attn.out.bias, seed,
                sm_scale=sm_scale, dropout_rate=rate,
            )
        else:
            attn_out = sliding_attention_block_train(
                hidden, *self._sliding_args(sliding), seed, sm_scale=sm_scale,
                window=cfg.attention_window, max_globals=cfg.max_global_tokens,
                dropout_rate=rate, global_rows=sliding.global_rows,
            )
        attn_out = dropout(attn_out, cfg.hidden_dropout, self.training, generator)
        hidden = self.attention_ln(hidden + attn_out)
        mlp = mlp_block_train(
            hidden.reshape(B * L, H), whole(self.mlp_in.kernel), whole(self.mlp_in.bias),
            whole(self.mlp_out.kernel), self.mlp_out.bias, activation=cfg.hidden_act,
        ).reshape(B, L, H)
        mlp = dropout(mlp, cfg.hidden_dropout, self.training, generator)
        return self.mlp_ln(hidden + mlp)


def sharded_mlp(x, mlp_in: Dense, mlp_out: Dense, act) -> torch.Tensor:
    """``mlp_out(act(mlp_in(x)))``; with ``mlp_in``'s columns and
    ``mlp_out``'s rows sharded over the model axis, this rank's columns'
    share summed over the model group, ``mlp_out``'s bias added once."""
    ax = shard_axis(mlp_in.kernel)
    if ax is None:
        return mlp_out(act(mlp_in(x)))
    h = act(mlp_in(ax.copy(x)))
    dt = h.dtype
    return ax.reduce(h @ mlp_out.kernel.to(dt)) + mlp_out.bias.to(dt)


def sliding_contract_breach(cfg: EncoderConfig, seq_len: int, prefix_globals: Optional[int],
                            has_global_mask: bool) -> Optional[str]:
    """Why the Longformer kernels cannot take this call (the contract of the
    TPU kernels), or None."""
    C = cfg.attention_window // 2
    if C <= 0 or seq_len % C or C % 8:
        return (f"sequence length {seq_len} must be a multiple of attention_window // 2 = {C}, "
                f"itself a multiple of 8")
    if prefix_globals is None or not has_global_mask:
        return ("no prefix_globals promise (suffix padding, global tokens a prefix) with a "
                "global_attention_mask")
    if prefix_globals > cfg.max_global_tokens:
        return f"prefix_globals {prefix_globals} above max_global_tokens {cfg.max_global_tokens}"
    return None


def bigbird_contract_breach(cfg: EncoderConfig, seq_len: int,
                            prefix_globals: Optional[int]) -> Optional[str]:
    """Why the BigBird kernels cannot take this call (the contract of the TPU
    kernels), or None."""
    C = cfg.bigbird_block_size
    if C <= 0 or seq_len % C or C % 8:
        return (f"sequence length {seq_len} must be a multiple of bigbird_block_size = {C}, "
                f"itself a multiple of 8")
    if prefix_globals is None:
        return "no prefix_globals promise (suffix padding)"
    return None


def _resolve_bigbird(cfg: EncoderConfig, device: torch.device, impl: str, seq_len: int,
                     prefix_globals: Optional[int]) -> str:
    """BigBird's path, as the JAX encoder resolves it: the training kernels
    whatever ``bigbird_impl`` says, the inference kernels under "auto" or
    "fused"; else "bias" or "block" ("auto": block above 1024 tokens,
    "fused": block)."""
    bb = cfg.bigbird_impl
    if bb not in ("auto", "bias", "block", "fused"):
        raise ValueError(f"bigbird_impl={bb!r}")
    if impl == "train_fused" or (impl == "fused" and bb in ("auto", "fused")):
        breach = bigbird_contract_breach(cfg, seq_len, prefix_globals)
        if breach is None:
            return impl
        if device.type == "cuda":
            raise ValueError(f"the BigBird kernels' contract is broken: {breach}; ask for "
                             f"attention_impl='einsum'")
    if bb == "auto":
        return "block" if seq_len > 1024 else "bias"
    return "bias" if bb == "bias" else "block"


def _resolve_flash(cfg: EncoderConfig, device: torch.device, training: bool,
                   seq_len: Optional[int]) -> str:
    """``"flash"`` on the port's own kernels. JAX runs its library's TPU
    flash kernel for dense models where ``flash_available`` holds and the
    einsum path anywhere else; here the einsum path off the card and for
    sparse trunks, and on the card kernel 6 (``"pallas"``) at inference or
    the training kernels (``"train_fused"``, which have a backward) in
    training. On the card a shape that ``flash_available`` refuses (L not a
    multiple of 128 and of min(L, 512), head_dim not of 8) raises."""
    if device.type != "cuda" or cfg.attention_type != "dense":
        return "einsum"
    if seq_len is None or seq_len % 128 or seq_len % min(seq_len, 512) or cfg.head_dim % 8:
        raise ValueError(f"attention_impl='flash' cannot take sequence length {seq_len} with "
                         f"head_dim {cfg.head_dim} (L a multiple of 128 and of min(L, 512), "
                         f"head_dim of 8); ask for attention_impl='einsum'")
    return "train_fused" if training else "pallas"


def resolve_attention_impl(
    cfg: EncoderConfig, device: torch.device, output_attentions: bool, training: bool = False,
    seq_len: Optional[int] = None, prefix_globals: Optional[int] = None,
    has_global_mask: bool = False, batch_size: Optional[int] = None,
    output_hidden_states: bool = False,
) -> str:
    """The path the encoder will run: "einsum", "fused", "stack", "pallas" or
    "train_fused" ("flash" resolves to one of them, ``_resolve_flash``), for sliding-window models the einsum path's "bias" or
    "chunked", for BigBird models its "bias" or "block"; raises for what the
    port does not have yet, and on CUDA for a sliding-window or BigBird call
    that breaks the kernels' contract. In training mode
    "fused" and "stack" mean the training kernels: the inference kernels
    have no backward and skip dropout. "stack" keeps no per-layer hidden
    states, so with ``output_hidden_states`` it is "fused", as in JAX."""
    if cfg.attention_type not in ("dense", "sliding_window", "bigbird"):
        raise NotImplementedError(f"attention_type={cfg.attention_type!r} is not ported yet")
    if cfg.quantize not in ("none", "w8a8"):
        raise ValueError(f"quantize={cfg.quantize!r}")
    impl = cfg.attention_impl
    if impl == "auto":
        if device.type != "cuda":
            impl = "einsum"
        elif training:
            impl = "train_fused"
        else:
            small = batch_size is not None and batch_size <= 32
            impl = "stack" if small and not output_hidden_states else "fused"
    if impl == "flash":
        impl = "einsum" if output_attentions else _resolve_flash(cfg, device, training, seq_len)
    if impl not in ("einsum", "fused", "train_fused", "stack", "pallas"):
        raise NotImplementedError(f"attention_impl={impl!r} is not ported yet")
    if training and impl in ("fused", "stack"):
        impl = "train_fused"
    if training and impl == "pallas" and device.type == "cuda":
        raise NotImplementedError("attention_impl='pallas' has no backward kernel; train with "
                                  "'fused' or 'einsum'")
    if impl == "stack" and (output_hidden_states or cfg.attention_type != "dense"):
        impl = "fused"
    # the kernels return no attention probabilities
    if output_attentions:
        impl = "einsum"
    if cfg.attention_type == "dense":
        return impl
    if impl == "pallas":
        impl = "einsum"  # JAX's pallas path is dense only
    if cfg.attention_type == "bigbird":
        return _resolve_bigbird(cfg, device, impl, seq_len, prefix_globals)
    sw = cfg.sliding_window_impl
    if sw not in ("auto", "bias", "chunked", "fused"):
        raise ValueError(f"sliding_window_impl={sw!r}")
    if impl != "einsum" and sw in ("auto", "fused"):
        breach = sliding_contract_breach(cfg, seq_len, prefix_globals, has_global_mask)
        if breach is None:
            return impl
        if device.type == "cuda":
            raise ValueError(f"the Longformer kernels' contract is broken: {breach}; ask for "
                             f"attention_impl='einsum' or sliding_window_impl='bias'/'chunked'")
    # the einsum path, as the JAX encoder resolves it off the TPU
    C = max(cfg.attention_window // 2, 1)
    chunked = sw in ("chunked", "fused") or (sw == "auto" and seq_len > 1024)
    return "chunked" if chunked and seq_len % C == 0 else "bias"


def checkpointed(fn, generator: Optional[torch.Generator], *args, **kwargs):
    """``fn(*args, generator=..., **kwargs)`` under gradient checkpointing
    (``torch.utils.checkpoint``, non-reentrant): its activations are not kept
    but recomputed in the backward. ``checkpoint`` restores only the default
    generators, so the layer draws its dropout masks and kernel seeds from a
    copy of ``generator`` made from the state ``generator`` has before the
    call, in the forward and again in the recompute; ``generator`` then
    continues from where the copy ended. The layer sees the same stream as
    without checkpointing, so its gradients are the same bit for bit."""
    if generator is None:  # the default generator: checkpoint restores it
        return checkpoint(fn, *args, generator=None, use_reentrant=False, **kwargs)
    start = generator.get_state()
    end = []

    def run(*a, **kw):
        g = torch.Generator(device=generator.device)
        g.set_state(start)
        out = fn(*a, generator=g, **kw)
        if not end:
            end.append(g.get_state())
        return out

    out = checkpoint(run, *args, use_reentrant=False, **kwargs)
    generator.set_state(end[0])
    return out


class Encoder(nn.Module):
    """The trunk: embeddings, N transformer layers, optional pooler.
    ``cfg.remat`` checkpoints every layer in training mode (``checkpointed``),
    on every path, as JAX wraps each layer in ``nn.remat``."""

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
        global_attention_mask: Optional[torch.Tensor] = None,
        prefix_globals: Optional[int] = None,
    ) -> EncoderOutput:
        """``pack_segment_ids`` (B, L): 0 on pad tokens, i + 1 on packed
        window i; tokens attend only within their window (dense models).
        ``generator`` draws the dropout masks and kernel seeds in training
        mode. Sliding-window models take ``global_attention_mask`` (B, L), 1
        on global tokens, and ``prefix_globals``: the promise that padding is
        a suffix and the global tokens the first ``prefix_globals`` positions
        at most, which the kernels need; BigBird models take
        ``prefix_globals`` (0) as the suffix-padding promise alone."""
        B, L = input_ids.shape
        cfg = self.cfg
        if attention_mask is None:
            attention_mask = torch.ones((B, L), dtype=torch.int32, device=input_ids.device)
        sliding = cfg.attention_type == "sliding_window"
        if cfg.attention_type != "dense" and pack_segment_ids is not None:
            raise NotImplementedError(f"pack_segment_ids with {cfg.attention_type} attention")
        impl = resolve_attention_impl(cfg, input_ids.device, output_attentions, self.training,
                                      L, prefix_globals, global_attention_mask is not None,
                                      batch_size=B, output_hidden_states=output_hidden_states)
        quantized = cfg.quantize == "w8a8" and not self.training
        seg = None
        if impl in ("fused", "train_fused", "stack", "pallas"):
            seg = pack_segment_ids if pack_segment_ids is not None else attention_mask
            seg = seg.to(torch.int32)

        hidden = self.embeddings(input_ids, token_type_ids, position_ids, generator)
        if impl == "stack":
            stacked = [torch.stack(ps) for ps in zip(*(l.stack_params() for l in self.layers()))]
            hidden = fused_encoder_stack(
                hidden, seg, *stacked, sm_scale=1.0 / math.sqrt(cfg.head_dim),
                quantized=cfg.quantize == "w8a8", activation=cfg.hidden_act,
                eps=cfg.layer_norm_eps,
            )
            pooled = torch.tanh(self.pooler(hidden[:, 0])) if self.pooler is not None else None
            return EncoderOutput(last_hidden_state=hidden, pooled_output=pooled)
        all_hidden = (hidden,) if output_hidden_states else None
        all_attn = () if output_attentions else None
        masks = None
        if sliding:
            masks = SlidingMasks(
                attention_mask=attention_mask, global_mask=global_attention_mask,
                key_padding_bias=(1.0 - attention_mask[:, None, None, :].float()) * NEG_INF,
                chunked=impl == "chunked", global_rows=(prefix_globals or 0) > 0,
            )
        # BigBird's kernels and block path read the (B, L) mask itself
        bigbird = (attention_mask if cfg.attention_type == "bigbird"
                   and impl in ("fused", "train_fused", "block") else None)
        remat = cfg.remat and self.training
        if impl in ("fused", "train_fused"):
            for layer in self.layers():
                if impl == "fused":
                    hidden = layer.forward_fused(hidden, seg, masks, quantized, bigbird)
                elif remat:
                    hidden = checkpointed(layer.forward_train_fused, generator, hidden, seg,
                                          sliding=masks, bigbird=bigbird)
                else:
                    hidden = layer.forward_train_fused(hidden, seg, generator, masks, bigbird)
                if output_hidden_states:
                    all_hidden = all_hidden + (hidden,)
        else:
            if impl == "bias" and sliding:
                bias = sliding_window_attention_mask_bias(
                    attention_mask, cfg.attention_window, global_attention_mask, NEG_INF,
                )[:, None]
            elif impl == "bias":
                bias = bigbird_attention_bias(
                    attention_mask, cfg.bigbird_block_size, cfg.bigbird_num_global_blocks,
                    cfg.bigbird_num_random_blocks, cfg.bigbird_seed, NEG_INF,
                )
            elif impl in ("chunked", "pallas", "block"):
                bias = None
            else:
                bias = (1.0 - attention_mask[:, None, None, :].float()) * NEG_INF
                if pack_segment_ids is not None:
                    same = pack_segment_ids[:, :, None] == pack_segment_ids[:, None, :]
                    bias = bias + torch.where(same, 0.0, NEG_INF)[:, None, :, :]
            for layer in self.layers():
                args = (hidden, bias, output_attentions)
                kw = dict(sliding=masks, quantized=quantized,
                          segment_ids=seg if impl == "pallas" else None, bigbird=bigbird)
                if remat:
                    hidden, probs = checkpointed(layer, generator, *args, **kw)
                else:
                    hidden, probs = layer(*args, generator=generator, **kw)
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
