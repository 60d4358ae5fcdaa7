"""GPT-2 causal decoder with a KV cache, for SLD, on PyTorch.

Counterpart of ``spokennlp_tpu/models/gpt2.py`` (the reference fine-tunes
HF GPT2LMHeadModel with a speech-extended vocabulary, reference: sld/
transformers/examples/pytorch/language-modeling/run_clm.py:455-483):
pre-LayerNorm blocks, a fused QKV projection, learned positions, the tanh
GELU and a weight-tied LM head computed in float32.

Parameter names and shapes follow the Flax tree (``h_{i}.attn.qkv.kernel``
(H, 3, nh, hd), ``h_{i}.attn.out.kernel`` (nh, hd, H), ``mlp_in`` /
``mlp_out`` kernels (in, out), ``ln_1`` / ``ln_2`` / ``ln_f`` with
``scale`` and ``bias``, ``wte.embedding``, ``wpe.embedding``), so a JAX tree
loads with ``load_state_dict(jax_params_to_state_dict(tree), strict=True)``.
Fresh weights take HF's init as JAX does: normal(0.02) for the tables and
the input projections, normal(0.02 / sqrt(2 n_layer)) for the two residual
projections, zero biases.

Masks are an additive -1e9: causal, and where an ``attention_mask`` is
given, padding. With a ``cache`` (``init_cache``: one (B, T, nh, hd) k and
v a layer, preallocated) the call writes its k and v at slots
[cache_index, cache_index + L) in place and attends over all T slots,
causally with respect to the slot. ``module.training`` plays JAX's
``deterministic=False``; dropout masks come from the ``generator`` given to
``forward``. The products stay ``torch.matmul``: the JAX model runs no
TPU kernel.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from spokennlp_tpu_torch.models.encoder import LayerNorm, dropout, lookup

NEG_INF = -1e9


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 1024
    layer_norm_eps: float = 1e-5
    embd_dropout: float = 0.1
    resid_dropout: float = 0.1
    attn_dropout: float = 0.1

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


def _normal(shape, std: float, generator) -> nn.Parameter:
    t = torch.empty(shape)
    nn.init.normal_(t, std=std, generator=generator)
    return nn.Parameter(t)


class _Dense(nn.Module):
    """A Flax dense layer: ``kernel`` of any (in..., out...) shape drawn
    normal(std), ``bias`` zeros."""

    def __init__(self, kernel_shape, bias_shape, std: float, generator=None):
        super().__init__()
        self.kernel = _normal(kernel_shape, std, generator)
        self.bias = nn.Parameter(torch.zeros(bias_shape))


class _Embed(nn.Module):
    def __init__(self, num: int, features: int, generator=None):
        super().__init__()
        self.embedding = _normal((num, features), 0.02, generator)


def init_cache(cfg: GPT2Config, batch_size: int, max_len: int, dtype=torch.float32,
               device=None) -> List[Dict[str, torch.Tensor]]:
    """One {"k", "v"} of zeros (B, T, nh, hd) a layer."""
    shape = (batch_size, max_len, cfg.num_heads, cfg.head_dim)
    return [{"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device)}
            for _ in range(cfg.num_layers)]


def attention_bias(L: int, attention_mask: Optional[torch.Tensor], device,
                   cache_len: Optional[int] = None, cache_index: int = 0) -> torch.Tensor:
    """(1|B, 1, L, T) additive bias, 0 where allowed and -1e9 elsewhere:
    causal over the L positions, or with ``cache_len`` causal with respect to
    the cache slots (query l sits at slot cache_index + l); ``attention_mask``
    (B, T) removes padded keys."""
    if cache_len is None:
        mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=device))
    else:
        pos = torch.arange(cache_len, device=device)
        ql = cache_index + torch.arange(L, device=device)
        mask = pos[None, :] <= ql[:, None]
    mask = mask[None, None]
    if attention_mask is not None:
        mask = mask & attention_mask[:, None, None, :].bool()
    return torch.where(mask, 0.0, NEG_INF)


class CausalSelfAttention(nn.Module):
    def __init__(self, cfg: GPT2Config, generator=None):
        super().__init__()
        self.cfg = cfg
        H, nh, hd = cfg.hidden_size, cfg.num_heads, cfg.head_dim
        self.qkv = _Dense((H, 3, nh, hd), (3, nh, hd), 0.02, generator)
        self.out = _Dense((nh, hd, H), (H,), 0.02 / math.sqrt(2 * cfg.num_layers), generator)

    def forward(self, hidden, bias, cache=None, cache_index: int = 0, generator=None):
        cfg = self.cfg
        dt = hidden.dtype
        L = hidden.shape[1]
        qkv = torch.einsum("blh,hsnd->blsnd", hidden, self.qkv.kernel.to(dt)) + self.qkv.bias.to(dt)
        q, k, v = qkv.unbind(2)  # (B, L, nh, hd)
        if cache is not None:
            # prefill (L = prompt length, cache_index 0) or decode (L = 1)
            cache["k"][:, cache_index : cache_index + L] = k.to(cache["k"].dtype)
            cache["v"][:, cache_index : cache_index + L] = v.to(cache["v"].dtype)
            k, v = cache["k"].to(dt), cache["v"].to(dt)
        scores = torch.einsum("blhd,bmhd->bhlm", q * (1.0 / math.sqrt(cfg.head_dim)), k)
        scores = scores + bias.to(scores.dtype)
        probs = F.softmax(scores.float(), dim=-1).to(dt)
        probs = dropout(probs, cfg.attn_dropout, self.training, generator)
        ctx = torch.einsum("bhlm,bmhd->blhd", probs, v)
        return torch.einsum("blnd,ndh->blh", ctx, self.out.kernel.to(dt)) + self.out.bias.to(dt)


class GPT2Block(nn.Module):
    def __init__(self, cfg: GPT2Config, generator=None):
        super().__init__()
        self.cfg = cfg
        H, I = cfg.hidden_size, cfg.intermediate_size
        self.ln_1 = LayerNorm(H, cfg.layer_norm_eps)
        self.attn = CausalSelfAttention(cfg, generator)
        self.ln_2 = LayerNorm(H, cfg.layer_norm_eps)
        self.mlp_in = _Dense((H, I), (I,), 0.02, generator)
        self.mlp_out = _Dense((I, H), (H,), 0.02 / math.sqrt(2 * cfg.num_layers), generator)

    def forward(self, hidden, bias, cache=None, cache_index: int = 0, generator=None):
        rate = self.cfg.resid_dropout
        dt = hidden.dtype
        attn = self.attn(self.ln_1(hidden), bias, cache, cache_index, generator)
        hidden = hidden + dropout(attn, rate, self.training, generator)
        x = self.ln_2(hidden)
        mlp = F.gelu(x @ self.mlp_in.kernel.to(dt) + self.mlp_in.bias.to(dt), approximate="tanh")
        mlp = mlp @ self.mlp_out.kernel.to(dt) + self.mlp_out.bias.to(dt)
        return hidden + dropout(mlp, rate, self.training, generator)


class GPT2LMModel(nn.Module):
    """Decoder + weight-tied LM head."""

    def __init__(self, cfg: GPT2Config, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config, self.dtype = cfg, dtype
        self.wte = _Embed(cfg.vocab_size, cfg.hidden_size, generator)
        self.wpe = _Embed(cfg.max_position_embeddings, cfg.hidden_size, generator)
        for i in range(cfg.num_layers):
            self.add_module(f"h_{i}", GPT2Block(cfg, generator))
        self.ln_f = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)

    def forward(self, input_ids, attention_mask=None, position_ids=None, cache=None,
                cache_index: int = 0, generator: Optional[torch.Generator] = None):
        """-> {"logits" (B, L, V) float32, "hidden" (B, L, H)}; ``cache``
        (``init_cache``) is written in place at ``cache_index``; with a
        cache, ``attention_mask`` is the (B, T) mask over its slots."""
        cfg = self.config
        B, L = input_ids.shape
        device = input_ids.device
        if position_ids is None:
            position_ids = cache_index + torch.arange(L, device=device)[None, :]
        # the deterministic table backward (encoder.lookup): the same bits
        # on every run
        hidden = (lookup(self.wte.embedding, input_ids).to(self.dtype)
                  + lookup(self.wpe.embedding, position_ids).to(self.dtype))
        hidden = dropout(hidden, cfg.embd_dropout, self.training, generator)
        if cache is None:
            bias = attention_bias(L, attention_mask, device)
        else:
            bias = attention_bias(L, attention_mask, device, cache[0]["k"].shape[1], cache_index)
        for i in range(cfg.num_layers):
            hidden = getattr(self, f"h_{i}")(hidden, bias, None if cache is None else cache[i],
                                             cache_index, generator)
        hidden = self.ln_f(hidden)
        logits = hidden.float() @ self.wte.embedding.float().T
        return {"logits": logits, "hidden": hidden}


# ---------------------------------------------------------------------------
# HF conversion
# ---------------------------------------------------------------------------


def gpt2_hf_to_params(sd: Dict[str, np.ndarray], cfg: GPT2Config,
                      prefix: str = "transformer.") -> Dict:
    """Map an HF GPT2LMHeadModel state dict onto GPT2LMModel params.

    HF GPT-2 uses Conv1D (weights already (in, out)): no transpose.
    """
    H, nh, hd = cfg.hidden_size, cfg.num_heads, cfg.head_dim
    p = prefix
    params: Dict = {
        "wte": {"embedding": sd[p + "wte.weight"][: cfg.vocab_size]},
        "wpe": {"embedding": sd[p + "wpe.weight"]},
        "ln_f": {"scale": sd[p + "ln_f.weight"], "bias": sd[p + "ln_f.bias"]},
    }
    for i in range(cfg.num_layers):
        lp = f"{p}h.{i}."
        cw = sd[lp + "attn.c_attn.weight"]  # (H, 3H), columns [q|k|v]
        cb = sd[lp + "attn.c_attn.bias"]
        params[f"h_{i}"] = {
            "ln_1": {"scale": sd[lp + "ln_1.weight"], "bias": sd[lp + "ln_1.bias"]},
            "ln_2": {"scale": sd[lp + "ln_2.weight"], "bias": sd[lp + "ln_2.bias"]},
            "attn": {
                "qkv": {"kernel": cw.reshape(H, 3, nh, hd), "bias": cb.reshape(3, nh, hd)},
                "out": {
                    "kernel": sd[lp + "attn.c_proj.weight"].reshape(nh, hd, H),
                    "bias": sd[lp + "attn.c_proj.bias"],
                },
            },
            "mlp_in": {
                "kernel": sd[lp + "mlp.c_fc.weight"],
                "bias": sd[lp + "mlp.c_fc.bias"],
            },
            "mlp_out": {
                "kernel": sd[lp + "mlp.c_proj.weight"],
                "bias": sd[lp + "mlp.c_proj.bias"],
            },
        }
    return params


def resize_token_embeddings(params: Dict, new_vocab_size: int, seed: int = 0) -> Dict:
    """Extend wte rows (normal init, std 0.02: HF's resize), drawn from
    numpy's ``default_rng(seed)`` as JAX draws them."""
    params = copy.deepcopy(params)
    emb = np.asarray(params["wte"]["embedding"])
    old, H = emb.shape
    if new_vocab_size <= old:
        params["wte"]["embedding"] = emb[:new_vocab_size]
        return params
    rng = np.random.default_rng(seed)
    extra = rng.normal(0.0, 0.02, size=(new_vocab_size - old, H)).astype(emb.dtype)
    params["wte"]["embedding"] = np.concatenate([emb, extra], axis=0)
    return params


def read_gpt2_checkpoint(path: str):
    """(config.json as a dict, numpy state dict) of an HF GPT-2 directory
    (``model.safetensors`` or ``pytorch_model.bin``), read without
    ``transformers``; a directory of another model type raises."""
    import json
    import os

    from spokennlp_tpu_torch.cli.hf_checkpoint import CONFIG_FILE, read_hf_state_dict
    from spokennlp_tpu_torch.models.hf_convert import torch_state_dict_to_numpy

    with open(os.path.join(path, CONFIG_FILE)) as f:
        hf_cfg = json.load(f)
    if hf_cfg.get("model_type") != "gpt2":
        raise ValueError(f"{path}: model_type {hf_cfg.get('model_type')!r}, expected 'gpt2'")
    return hf_cfg, torch_state_dict_to_numpy(read_hf_state_dict(path))
