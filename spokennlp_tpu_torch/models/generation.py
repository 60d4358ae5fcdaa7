"""Autoregressive generation (greedy and beam) over GPT-2's KV cache, on
PyTorch.

Counterpart of ``spokennlp_tpu/models/generation.py`` (the reference's
per-epoch ``model.generate`` decode, sld/.../run_clm.py:647-739: left-padded
prompts, decode to block_size, early stopping). JAX's ``lax.while_loop``
becomes a Python loop over a preallocated (B, T, nh, hd) cache a layer
(models/gpt2.py ``init_cache``): the prompt is prefilled at slot 0, then one
token a step at slot t. The loop keeps JAX's semantics:

- prompt positions count the real tokens of a left-padded row
  (``_prompt_position_ids``); decode positions continue from ``n_real``;
- the body writes the PREVIOUS step's prediction at slot t, a finished row
  repeats EOS, and the loop stops at ``max_len`` or when every row is done;
  the prediction still pending then is flushed into its slot (the final
  EOS, which the loop would otherwise drop);
- beam search keeps (B * K) rows of cache, starts from beam 0's top K
  only, extends a finished beam only with EOS at zero cost, gathers the
  cache on reordering, freezes a beam's length when it finishes, and picks
  the best beam by score / max(length ** length_penalty, 1).

Ties: ``torch.argmax`` takes the first maximum, as ``jnp.argmax`` does, and
``top_k`` takes the lower index first, as ``jax.lax.top_k`` does
(``torch.topk`` does not promise an order among equal values).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from spokennlp_tpu_torch.models.gpt2 import GPT2LMModel, init_cache

NEG_INF = -1e9


def _prompt_position_ids(attention_mask: torch.Tensor) -> torch.Tensor:
    """Left-padded prompts: positions count real tokens (pads get 0)."""
    am = attention_mask.long()
    return torch.clamp(torch.cumsum(am, dim=1) - 1, min=0) * am


def top_k(x: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last axis, equal values
    in index order (``jax.lax.top_k``'s order): a stable descending sort."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def _prefill(model: GPT2LMModel, ids, mask, max_len: int):
    """(cache, (B, max_len) slot mask, last prompt logits) after the prompt."""
    B, P = ids.shape
    cache = init_cache(model.config, B, max_len, model.dtype, ids.device)
    am_full = torch.zeros((B, max_len), dtype=torch.int32, device=ids.device)
    am_full[:, :P] = mask
    out = model(ids, am_full, _prompt_position_ids(mask), cache, 0)
    return cache, am_full, out["logits"][:, -1, :]


@torch.no_grad()
def greedy_generate(model: GPT2LMModel, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                    max_len: int, eos_id: int) -> torch.Tensor:
    """Greedy decode. input_ids (B, P) LEFT-padded; returns (B, max_len)
    int32 where [:, :P] is the prompt and generation continues to max_len
    (EOS repeats once a row finishes)."""
    model.eval()
    B, P = input_ids.shape
    cache, am_full, logits = _prefill(model, input_ids, attention_mask, max_len)
    next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
    n_real = attention_mask.long().sum(dim=1)
    seqs = torch.zeros((B, max_len), dtype=torch.int32, device=input_ids.device)
    seqs[:, :P] = input_ids
    finished = next_tok == eos_id
    t = P
    while t < max_len and not bool(finished.all()):
        tok = torch.where(finished, eos_id, next_tok).to(torch.int32)
        seqs[:, t] = tok
        am_full[:, t] = 1
        out = model(tok[:, None], am_full, n_real[:, None], cache, t)
        next_tok = torch.argmax(out["logits"][:, -1, :], dim=-1).to(torch.int32)
        finished = finished | (next_tok == eos_id)
        n_real = n_real + 1
        t += 1
    # flush the pending prediction: the body writes the PREVIOUS step's
    # token, so when every row finished the EOS that finished the last
    # row(s) was never written
    if t < max_len:
        seqs[:, t] = torch.where(finished, eos_id, next_tok).to(torch.int32)
    return seqs


@torch.no_grad()
def beam_generate(model: GPT2LMModel, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                  max_len: int, eos_id: int, num_beams: int = 4,
                  length_penalty: float = 1.0) -> torch.Tensor:
    """Beam search; returns the best beam per row, (B, max_len) int32."""
    model.eval()
    B, P = input_ids.shape
    K = num_beams
    V = model.config.vocab_size
    device = input_ids.device
    ids_f = torch.repeat_interleave(input_ids, K, dim=0)  # (B*K, P)
    am_f = torch.repeat_interleave(attention_mask.to(torch.int32), K, dim=0)
    cache, am_full, logits = _prefill(model, ids_f, am_f, max_len)
    logp0 = F.log_softmax(logits.float(), dim=-1).reshape(B, K, V)
    # the first expansion from beam 0 only
    scores, next_tok = top_k(logp0[:, 0, :], K)  # (B, K)
    next_tok = next_tok.to(torch.int32)
    seqs = torch.zeros((B, K, max_len), dtype=torch.int32, device=device)
    seqs[:, :, :P] = ids_f.reshape(B, K, P)
    finished = next_tok == eos_id
    n_real = am_f.reshape(B, K, -1).long().sum(dim=-1)
    eos_only = torch.full((V,), NEG_INF, device=device)
    eos_only[eos_id] = 0.0
    rows = torch.arange(B, device=device)[:, None] * K
    t = P
    while t < max_len and not bool(finished.all()):
        tok = torch.where(finished, eos_id, next_tok).to(torch.int32)
        seqs[:, :, t] = tok
        am_full[:, t] = 1
        out = model(tok.reshape(B * K, 1), am_full, n_real.reshape(B * K, 1), cache, t)
        logp = F.log_softmax(out["logits"][:, -1, :].float(), -1).reshape(B, K, V)
        # finished beams may only extend with EOS at zero cost
        logp = torch.where(finished[..., None], eos_only[None, None, :], logp)
        cand = (scores[..., None] + logp).reshape(B, K * V)
        scores, idx = top_k(cand, K)
        beam_idx, tok_idx = idx // V, (idx % V).to(torch.int32)
        flat = (rows + beam_idx).reshape(-1)  # reorder the beam state
        for layer in cache:
            layer["k"] = layer["k"].index_select(0, flat)
            layer["v"] = layer["v"].index_select(0, flat)
        am_full = am_full.index_select(0, flat)
        seqs = torch.take_along_dim(seqs, beam_idx[..., None], dim=1)
        n_real = torch.take_along_dim(n_real, beam_idx, dim=1)
        finished = torch.take_along_dim(finished, beam_idx, dim=1)
        # a beam's length freezes when it finishes: the step that emits EOS
        # still counts, the EOS padding after it does not
        n_real = n_real + (~finished).long()
        finished = finished | (tok_idx == eos_id)
        next_tok = tok_idx
        t += 1
    if t < max_len:  # flush the pending prediction, as in greedy_generate
        seqs[:, :, t] = torch.where(finished, eos_id, next_tok).to(torch.int32)
    norm = torch.pow(n_real.float(), length_penalty)
    best = torch.argmax(scores / torch.clamp(norm, min=1.0), dim=1)  # (B,)
    return torch.take_along_dim(seqs, best[:, None, None], dim=1)[:, 0, :]
