"""PALM 2.0 encoder-decoder with the pointer-generator copy mechanism, on
PyTorch.

Counterpart of ``spokennlp_tpu/models/palm.py`` (MUG Track 3's baseline,
ModelScope's ``damo/nlp_palm2.0_text-generation_chinese-base``):

  encoder   the shared BERT trunk (PALM-chinese-base: 12 layers)
  decoder   pre-norm transformer decoder, OpenNMT TransformerDecoderLayer
            semantics:
              q  = x + drop(SelfAttn(LN1(x), causal))
              m  = q + drop(CrossAttn(LN2(q), enc_out))
              out= m + drop(w2(drop(gelu(w1(LN_ff(m))))))
            sinusoidal positions added to sqrt(H)-scaled target embeddings,
            and a final decoder LayerNorm.
  generator pointer-generator (OpenNMT CopyGenerator semantics):
              p_copy  = sigmoid(linear_copy(h))
              p_vocab = softmax(generator(h)) * (1 - p_copy)
              p_final = p_vocab + scatter_add(copy_attn * p_copy, src_ids)
            copy_attn is the last decoder layer's cross-attention
            distribution, averaged over heads and masked to real source
            tokens.

JAX adds the copy mass by a one-hot einsum over (B*K, S, V), 692 MB a step
at PALM's V = 21128, S = 512 and B*K = 16; the port adds the same sums with
``scatter_add`` onto the source ids. ``hf_convert.palm_to_params`` maps the
ModelScope palm_v2 state dict onto this module's tree (the Flax names:
``decoder_layer_{i}.self_attn_query``, ``context_attn_final``,
``layer_norm_1``, ``ff_layer_norm``, ``w_1``, ``decoder_ln``,
``generator``, ``linear_copy``, ...). Decoding keeps JAX's loop: the whole
model, encoder included, runs again at every decode step.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from spokennlp_tpu_torch.configs import EncoderConfig
from spokennlp_tpu_torch.models.encoder import Dense, Embed, Encoder, LayerNorm, dropout
from spokennlp_tpu_torch.models.seq2seq import beam_search, self_attention_bias

NEG_INF = -1e9


@dataclasses.dataclass(frozen=True)
class PalmConfig:
    vocab_size: int = 21128  # Chinese BERT vocab
    hidden_size: int = 768
    num_decoder_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_target_length: int = 128
    layer_norm_eps: float = 1e-6  # OpenNMT LayerNorm default
    dropout: float = 0.1
    bos_token_id: int = 101  # [CLS] starts generation (PALM convention)
    eos_token_id: int = 102  # [SEP]
    pad_token_id: int = 0
    use_copy: bool = True


def sinusoidal_positions(max_len: int, dim: int) -> np.ndarray:
    """OpenNMT PositionalEncoding table (sin on even, cos on odd dims)."""
    pe = np.zeros((max_len, dim), np.float32)
    position = np.arange(max_len)[:, None].astype(np.float32)
    div = np.exp(np.arange(0, dim, 2).astype(np.float32) * -(np.log(10000.0) / dim))
    pe[:, 0::2] = np.sin(position * div)
    pe[:, 1::2] = np.cos(position * div)
    return pe


class PalmDecoderLayer(nn.Module):
    """Pre-norm OpenNMT decoder layer; returns (x, the cross-attention
    probabilities (B, nh, Lt, S) in float32, before dropout)."""

    def __init__(self, cfg: PalmConfig, generator=None):
        super().__init__()
        self.cfg = cfg
        H = cfg.hidden_size
        for name in ("self_attn", "context_attn"):
            for part in ("query", "keys", "values", "final"):
                self.add_module(f"{name}_{part}", Dense(H, H, generator))
        self.layer_norm_1 = LayerNorm(H, cfg.layer_norm_eps)
        self.layer_norm_2 = LayerNorm(H, cfg.layer_norm_eps)
        self.ff_layer_norm = LayerNorm(H, cfg.layer_norm_eps)
        self.w_1 = Dense(H, cfg.intermediate_size, generator)
        self.w_2 = Dense(cfg.intermediate_size, H, generator)

    def mha(self, q_in, kv_in, bias, name, generator):
        """OpenNMT MultiHeadedAttention: four (H, H) linears."""
        c = self.cfg
        H, nh = c.hidden_size, c.num_heads
        hd = H // nh
        q = getattr(self, f"{name}_query")(q_in)
        k = getattr(self, f"{name}_keys")(kv_in)
        v = getattr(self, f"{name}_values")(kv_in)
        B, Lq, Lk = q.shape[0], q.shape[1], k.shape[1]
        q, k, v = q.reshape(B, Lq, nh, hd), k.reshape(B, Lk, nh, hd), v.reshape(B, Lk, nh, hd)
        s = torch.einsum("blhd,bmhd->bhlm", q.float(), k.float()) * (1.0 / math.sqrt(hd)) + bias
        p = F.softmax(s, -1)
        pd = dropout(p.to(q.dtype), c.dropout, self.training, generator)
        ctx = torch.einsum("bhlm,bmhd->blhd", pd, v).reshape(B, Lq, H)
        return getattr(self, f"{name}_final")(ctx), p

    def forward(self, x, enc_out, enc_mask, self_mask, generator=None):
        rate, training = self.cfg.dropout, self.training
        xn = self.layer_norm_1(x)
        sa, _ = self.mha(xn, xn, self_mask, "self_attn", generator)
        q = x + dropout(sa, rate, training, generator)
        qn = self.layer_norm_2(q)
        cross_bias = (1.0 - enc_mask[:, None, None, :].float()) * NEG_INF
        ca, cross_probs = self.mha(qn, enc_out, cross_bias, "context_attn", generator)
        m = q + dropout(ca, rate, training, generator)
        inter = F.gelu(self.w_1(self.ff_layer_norm(m)), approximate="none")
        inter = dropout(inter, rate, training, generator)
        out = dropout(self.w_2(inter), rate, training, generator)
        return m + out, cross_probs


class PalmModel(nn.Module):
    """PALM 2.0: BERT encoder + pre-norm decoder + pointer-generator.
    ``forward`` returns per-position LOG-probabilities over the vocabulary
    (the copy mixture lives in probability space)."""

    def __init__(self, enc_cfg: EncoderConfig, cfg: PalmConfig,
                 dtype: torch.dtype = torch.float32, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.enc_cfg, self.cfg, self.dtype = enc_cfg, cfg, dtype
        H = cfg.hidden_size
        self.encoder = Encoder(enc_cfg, dtype, generator)
        self.dec_embed = Embed(cfg.vocab_size, H, generator)
        for i in range(cfg.num_decoder_layers):
            self.add_module(f"decoder_layer_{i}", PalmDecoderLayer(cfg, generator))
        self.decoder_ln = LayerNorm(H, cfg.layer_norm_eps)
        self.generator = Dense(H, cfg.vocab_size, generator)
        self.linear_copy = Dense(H, 1, generator) if cfg.use_copy else None
        self.register_buffer(
            "positions", torch.tensor(sinusoidal_positions(cfg.max_target_length, H)),
            persistent=False)

    def forward(self, input_ids, attention_mask, decoder_input_ids,
                decoder_attention_mask=None,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """-> {"log_probs" (B, Lt, V), "logits" (the generator's), and with
        the copy mechanism "p_copy" (B, Lt, 1)}, all float32."""
        c = self.cfg
        enc_out = self.encoder(input_ids, attention_mask=attention_mask,
                               generator=generator).last_hidden_state
        Lt = decoder_input_ids.shape[1]
        # OpenNMT scales embeddings by sqrt(dim) before adding the sinusoids
        x = (self.dec_embed(decoder_input_ids, self.dtype) * math.sqrt(c.hidden_size)
             + self.positions[:Lt].to(self.dtype)[None])
        x = dropout(x, c.dropout, self.training, generator)
        self_mask = self_attention_bias(Lt, decoder_attention_mask, x.device)
        cross_probs = None
        for i in range(c.num_decoder_layers):
            x, cross_probs = getattr(self, f"decoder_layer_{i}")(
                x, enc_out, attention_mask, self_mask, generator)
        h = self.decoder_ln(x).float()
        vocab_logits = self.generator(h)
        if self.linear_copy is None:
            return {"log_probs": F.log_softmax(vocab_logits, -1), "logits": vocab_logits}

        p_copy = torch.sigmoid(self.linear_copy(h))  # (B, Lt, 1)
        p_vocab = F.softmax(vocab_logits, -1) * (1.0 - p_copy)
        # the copy distribution: the last layer's cross attention, averaged
        # over heads, masked to real source tokens
        attn = cross_probs.float().mean(dim=1)  # (B, Lt, S)
        attn = attn * attention_mask[:, None, :].float()
        attn = attn / attn.sum(-1, keepdim=True).clamp_min(1e-9)
        copy_mass = attn * p_copy
        # JAX's one-hot einsum over (B, S, V), as a scatter onto the source ids
        src = input_ids.long()[:, None, :].expand(-1, Lt, -1)
        p_final = p_vocab.scatter_add(-1, src, copy_mass)
        logp = torch.log(p_final.clamp_min(1e-9))
        return {"log_probs": logp, "logits": vocab_logits, "p_copy": p_copy}


def palm_loss(model: PalmModel, batch: Dict[str, torch.Tensor],
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Teacher-forced NLL over the copy-mixture log-probs (ignore -100).
    Dropout runs when the model is in training mode."""
    out = model(batch["input_ids"], batch["attention_mask"], batch["decoder_input_ids"],
                decoder_attention_mask=batch.get("decoder_attention_mask"), generator=generator)
    logp = out["log_probs"]
    labels = batch["labels"]
    valid = labels != -100
    safe = torch.where(valid, labels, 0).long()
    nll = -torch.take_along_dim(logp, safe[..., None], dim=-1)[..., 0]
    return (nll * valid).sum() / valid.sum().clamp_min(1)


@torch.no_grad()
def palm_beam_decode(model: PalmModel, input_ids, attention_mask, num_beams: int = 4,
                     length_penalty: float = 1.0, max_len: Optional[int] = None) -> torch.Tensor:
    """Beam decode over the copy-mixture log-probs (``seq2seq.beam_search``'s
    loop; the whole model runs again at each step). Returns (B, max_len)."""
    c = model.cfg
    max_len = max_len or c.max_target_length
    model.eval()
    enc_ids = torch.repeat_interleave(input_ids, num_beams, dim=0)
    enc_mask = torch.repeat_interleave(attention_mask, num_beams, dim=0)

    def step(dec, dec_mask, t):
        out = model(enc_ids, enc_mask, dec, decoder_attention_mask=dec_mask)
        return out["log_probs"][:, t - 1, :]

    return beam_search(step, c, input_ids.shape[0], num_beams, length_penalty, max_len,
                       input_ids.device)
