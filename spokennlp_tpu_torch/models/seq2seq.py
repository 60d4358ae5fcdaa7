"""Encoder-decoder transformer for topic title generation (MUG Track 3), on
PyTorch.

Counterpart of ``spokennlp_tpu/models/seq2seq.py``: the shared encoder trunk
encodes the topic text; a post-norm causal decoder with cross-attention
generates the title; the LM head is the decoder embedding itself (Flax's
``tok.attend``), so the state dict holds one ``dec_embed.embedding``, as
the Flax tree does. ``enc_proj`` exists only when the encoder's width
differs from the decoder's. The causal, padding and cross-attention masks
are an additive -1e9.

Decoding (``greedy_decode``, ``beam_decode``) keeps JAX's loops: no KV
cache, the whole model (encoder included) runs again over the fixed-length
prefix at every step, beams ride the batch axis (B*K), a finished beam
extends only with pad at zero cost and freezes its length, and the loop
stops when every beam is done. On the card the encoder in eval mode runs
the whole-stack kernel (kernel 3) once a step for B*K <= 32.

Parameter names follow the Flax tree (``decoder_layer_{i}.self_q.kernel``
(H, nh, hd), ``self_o.kernel`` (nh, hd, H), ...), so a JAX tree loads with
``load_state_dict(jax_params_to_state_dict(tree), strict=True)``.
``module.training`` plays JAX's ``deterministic=False``; dropout masks come
from the ``generator`` given to ``forward``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from spokennlp_tpu_torch.configs import EncoderConfig
from spokennlp_tpu_torch.models.encoder import (
    Dense, Embed, Encoder, LayerNorm, _lecun_normal_, dropout,
)
from spokennlp_tpu_torch.ops.losses import cross_entropy_with_ignore

NEG_INF = -1e9


@dataclasses.dataclass(frozen=True)
class Seq2SeqConfig:
    vocab_size: int = 21128  # Chinese BERT vocab default
    hidden_size: int = 256
    num_decoder_layers: int = 4
    num_heads: int = 4
    intermediate_size: int = 1024
    max_target_length: int = 64
    layer_norm_eps: float = 1e-12
    dropout: float = 0.1
    bos_token_id: int = 101
    eos_token_id: int = 102
    pad_token_id: int = 0


class HeadsProj(nn.Module):
    """Flax ``DenseGeneral((nh, hd), axis=-1)``: ``kernel`` (H, nh, hd),
    ``bias`` (nh, hd)."""

    def __init__(self, hidden: int, num_heads: int, head_dim: int, generator=None):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(hidden, num_heads, head_dim))
        self.bias = nn.Parameter(torch.zeros(num_heads, head_dim))
        _lecun_normal_(self.kernel.data, hidden, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, L, H) -> (B, L, nh, hd)
        return torch.einsum("blh,hnd->blnd", x, self.kernel.to(x.dtype)) + self.bias.to(x.dtype)


class HeadsOut(nn.Module):
    """Flax ``DenseGeneral(H, axis=(-2, -1))``: ``kernel`` (nh, hd, H),
    ``bias`` (H,)."""

    def __init__(self, num_heads: int, head_dim: int, features: int, generator=None):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(num_heads, head_dim, features))
        self.bias = nn.Parameter(torch.zeros(features))
        _lecun_normal_(self.kernel.data, num_heads * head_dim, generator)

    def forward(self, ctx: torch.Tensor) -> torch.Tensor:  # (B, L, nh, hd) -> (B, L, H)
        return torch.einsum("blnd,ndh->blh", ctx, self.kernel.to(ctx.dtype)) + self.bias.to(
            ctx.dtype)


class DecoderLayer(nn.Module):
    """Post-norm decoder layer: self-attention, cross-attention, GELU (erf)
    MLP, each added to its input and LayerNormed."""

    def __init__(self, cfg: Seq2SeqConfig, generator=None):
        super().__init__()
        self.cfg = cfg
        H, nh = cfg.hidden_size, cfg.num_heads
        hd = H // nh
        for name in ("self", "cross"):
            for part in ("q", "k", "v"):
                self.add_module(f"{name}_{part}", HeadsProj(H, nh, hd, generator))
            self.add_module(f"{name}_o", HeadsOut(nh, hd, H, generator))
        self.self_ln = LayerNorm(H, cfg.layer_norm_eps)
        self.cross_ln = LayerNorm(H, cfg.layer_norm_eps)
        self.mlp_in = Dense(H, cfg.intermediate_size, generator)
        self.mlp_out = Dense(cfg.intermediate_size, H, generator)
        self.mlp_ln = LayerNorm(H, cfg.layer_norm_eps)

    def mha(self, q_in, kv_in, bias, name, generator):
        dt = q_in.dtype
        hd = self.cfg.hidden_size // self.cfg.num_heads
        q = getattr(self, f"{name}_q")(q_in)
        k = getattr(self, f"{name}_k")(kv_in)
        v = getattr(self, f"{name}_v")(kv_in)
        s = torch.einsum("blhd,bmhd->bhlm", q * (1.0 / math.sqrt(hd)), k) + bias.to(dt)
        p = F.softmax(s.float(), -1).to(dt)
        p = dropout(p, self.cfg.dropout, self.training, generator)
        ctx = torch.einsum("bhlm,bmhd->blhd", p, v)
        return getattr(self, f"{name}_o")(ctx)

    def forward(self, x, enc_out, enc_mask, self_mask, generator=None):
        rate = self.cfg.dropout
        attn = self.mha(x, x, self_mask, "self", generator)
        x = self.self_ln(x + dropout(attn, rate, self.training, generator))
        cross_bias = (1.0 - enc_mask[:, None, None, :].float()) * NEG_INF
        cross = self.mha(x, enc_out, cross_bias, "cross", generator)
        x = self.cross_ln(x + dropout(cross, rate, self.training, generator))
        mlp = self.mlp_out(F.gelu(self.mlp_in(x), approximate="none"))
        return self.mlp_ln(x + dropout(mlp, rate, self.training, generator))


def self_attention_bias(Lt: int, decoder_attention_mask: Optional[torch.Tensor],
                        device) -> torch.Tensor:
    """The causal (and, with a decoder mask, padding) additive bias:
    (1|B, 1, Lt, Lt), 0 where allowed and -1e9 elsewhere."""
    causal = torch.tril(torch.ones((Lt, Lt), dtype=torch.bool, device=device))
    if decoder_attention_mask is not None:
        causal = causal[None, :, :] & decoder_attention_mask[:, None, :].bool()
        return torch.where(causal, 0.0, NEG_INF)[:, None, :, :]
    return torch.where(causal, 0.0, NEG_INF)[None, None, :, :]


class Seq2SeqModel(nn.Module):
    """Encoder trunk + causal decoder with cross-attention + tied LM head."""

    def __init__(self, enc_cfg: EncoderConfig, cfg: Seq2SeqConfig,
                 dtype: torch.dtype = torch.float32, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.enc_cfg, self.cfg, self.dtype = enc_cfg, cfg, dtype
        H = cfg.hidden_size
        self.encoder = Encoder(enc_cfg, dtype, generator)
        self.enc_proj = (Dense(enc_cfg.hidden_size, H, generator)
                         if enc_cfg.hidden_size != H else None)
        self.dec_embed = Embed(cfg.vocab_size, H, generator)
        self.dec_pos = Embed(cfg.max_target_length, H, generator)
        for i in range(cfg.num_decoder_layers):
            self.add_module(f"decoder_layer_{i}", DecoderLayer(cfg, generator))

    def forward(self, input_ids, attention_mask, decoder_input_ids,
                decoder_attention_mask=None,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """-> {"logits" (B, Lt, V), "encoder_output"}."""
        c = self.cfg
        enc_out = self.encoder(input_ids, attention_mask=attention_mask,
                               generator=generator).last_hidden_state
        if self.enc_proj is not None:
            enc_out = self.enc_proj(enc_out)
        Lt = decoder_input_ids.shape[1]
        pos = torch.arange(Lt, device=decoder_input_ids.device)[None, :]
        x = self.dec_embed(decoder_input_ids, self.dtype) + self.dec_pos(pos, self.dtype)
        x = dropout(x, c.dropout, self.training, generator)
        self_mask = self_attention_bias(Lt, decoder_attention_mask, x.device)
        for i in range(c.num_decoder_layers):
            x = getattr(self, f"decoder_layer_{i}")(x, enc_out, attention_mask, self_mask,
                                                   generator)
        # Flax's Embed.attend: the query and the table in the module's dtype
        emb = self.dec_embed.embedding.to(self.dtype)
        logits = x.to(self.dtype) @ emb.T
        return {"logits": logits, "encoder_output": enc_out}


def seq2seq_loss(model: Seq2SeqModel, batch: Dict[str, torch.Tensor],
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Teacher-forced CE: decoder input = [BOS] target[:-1], labels = target
    (ignore -100). Dropout runs when the model is in training mode."""
    out = model(batch["input_ids"], batch["attention_mask"], batch["decoder_input_ids"],
                decoder_attention_mask=batch.get("decoder_attention_mask"), generator=generator)
    return cross_entropy_with_ignore(out["logits"], batch["labels"])


@torch.no_grad()
def greedy_decode(model: Seq2SeqModel, input_ids, attention_mask,
                  max_len: Optional[int] = None) -> torch.Tensor:
    """Greedy title decode: the model re-runs over the fixed-length prefix
    every step (no KV cache), as in JAX. Returns (B, max_len) int ids."""
    c = model.cfg
    max_len = max_len or c.max_target_length
    B = input_ids.shape[0]
    device = input_ids.device
    model.eval()
    dec = torch.full((B, max_len), c.pad_token_id, dtype=torch.int32, device=device)
    dec[:, 0] = c.bos_token_id
    dec_mask = torch.zeros((B, max_len), dtype=torch.int32, device=device)
    dec_mask[:, 0] = 1
    finished = torch.zeros((B,), dtype=torch.bool, device=device)
    for t in range(1, max_len):
        logits = model(input_ids, attention_mask, dec, decoder_attention_mask=dec_mask)["logits"]
        nxt = torch.argmax(logits[:, t - 1, :], dim=-1).to(torch.int32)
        nxt = torch.where(finished, c.pad_token_id, nxt).to(torch.int32)
        dec[:, t] = nxt
        dec_mask[:, t] = (~finished).to(torch.int32)
        finished = finished | (nxt == c.eos_token_id)
        if bool(finished.all()):
            break
    return dec


def beam_search(step_log_probs, cfg, B: int, num_beams: int, length_penalty: float,
                max_len: int, device) -> torch.Tensor:
    """The beam loop of ``beam_decode`` and ``palm_beam_decode``:
    ``step_log_probs(dec (B*K, max_len), dec_mask, t)`` gives the (B*K, V)
    float32 log-probabilities of position t. Beam 0 starts at score 0, the
    others at -1e9; a finished beam extends only with pad at zero cost and
    freezes its length; candidates are ranked by ``torch.topk`` (sorted);
    the loop stops when every beam is done. Returns (B, max_len) ids of each
    row's best beam by score / length ** length_penalty."""
    K = num_beams
    dec = torch.full((B, K, max_len), cfg.pad_token_id, dtype=torch.int32, device=device)
    dec[:, :, 0] = cfg.bos_token_id
    dec_mask = torch.zeros((B, K, max_len), dtype=torch.int32, device=device)
    dec_mask[:, :, 0] = 1
    scores = torch.where(torch.arange(K, device=device) == 0, 0.0, NEG_INF)[None, :].repeat(B, 1)
    finished = torch.zeros((B, K), dtype=torch.bool, device=device)
    lengths = torch.ones((B, K), dtype=torch.float32, device=device)
    for t in range(1, max_len):
        logp = step_log_probs(dec.reshape(B * K, max_len), dec_mask.reshape(B * K, max_len), t)
        V = logp.shape[-1]
        logp = logp.reshape(B, K, V)
        pad_only = torch.full((V,), NEG_INF, device=device)
        pad_only[cfg.pad_token_id] = 0.0
        logp = torch.where(finished[..., None], pad_only[None, None, :], logp)
        cand = (scores[..., None] + logp).reshape(B, K * V)
        scores, idx = torch.topk(cand, K, dim=-1, sorted=True)
        beam_idx, tok = idx // V, (idx % V).to(torch.int32)
        dec = torch.take_along_dim(dec, beam_idx[..., None], dim=1)
        dec_mask = torch.take_along_dim(dec_mask, beam_idx[..., None], dim=1)
        finished = torch.take_along_dim(finished, beam_idx, dim=1)
        lengths = torch.take_along_dim(lengths, beam_idx, dim=1)
        dec[:, :, t] = torch.where(finished, cfg.pad_token_id, tok).to(torch.int32)
        dec_mask[:, :, t] = (~finished).to(torch.int32)
        lengths = lengths + (~finished).float()
        finished = finished | (tok == cfg.eos_token_id)
        if bool(finished.all()):
            break
    norm = torch.pow(lengths.clamp_min(1.0), length_penalty)
    best = torch.argmax(scores / norm, dim=1)
    return torch.take_along_dim(dec, best[:, None, None], dim=1)[:, 0, :]


@torch.no_grad()
def beam_decode(model: Seq2SeqModel, input_ids, attention_mask, num_beams: int = 4,
                length_penalty: float = 1.0, max_len: Optional[int] = None) -> torch.Tensor:
    """Beam-search title decode over log_softmax of the logits (the
    reference decodes PALM 2.0 with beams). ``num_beams=1`` reproduces
    ``greedy_decode``. Returns (B, max_len) int ids."""
    c = model.cfg
    max_len = max_len or c.max_target_length
    model.eval()
    enc_ids = torch.repeat_interleave(input_ids, num_beams, dim=0)  # (B*K, S)
    enc_mask = torch.repeat_interleave(attention_mask, num_beams, dim=0)

    def step(dec, dec_mask, t):
        logits = model(enc_ids, enc_mask, dec, decoder_attention_mask=dec_mask)["logits"]
        return F.log_softmax(logits[:, t - 1, :].float(), -1)

    return beam_search(step, c, input_ids.shape[0], num_beams, length_penalty, max_len,
                       input_ids.device)
