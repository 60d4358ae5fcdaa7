"""Linear-chain CRF: log-likelihood (forward algorithm) and Viterbi decode.

Counterpart of ``spokennlp_tpu/ops/crf.py``, which backs the BERT-CRF
keyphrase tagger of MUG Track 4. The JAX functions are ``lax.scan``
programs; here each scan step is one step of a Python loop over the
sequence, with the same mask-gated updates, and autograd gives the
gradient. The semantics of the scan are kept:

- the forward pass starts from ``emissions[:, 0]`` whatever the mask says;
- a masked step keeps ``alpha`` and takes the identity as its backpointer;
- ties go to the first maximal index (``torch.argmax`` documents that, as
  ``jnp.argmax`` does; ``torch.max(dim).indices`` makes no such promise on
  CUDA);
- the log-likelihood is the batch mean.

There is no kernel here: the JAX package has none for the CRF.
"""

from __future__ import annotations

from typing import Tuple

import torch

NEG_INF = -1e9


def crf_log_likelihood(
    emissions: torch.Tensor,  # (B, L, T) log potentials
    tags: torch.Tensor,  # (B, L) int
    mask: torch.Tensor,  # (B, L) 1 = valid; position 0 must be valid
    transitions: torch.Tensor,  # (T, T): transitions[i, j] = score of i -> j
) -> torch.Tensor:
    """Mean log-likelihood log p(tags | emissions) over the batch."""
    score = _sequence_score(emissions, tags, mask, transitions)
    log_z = _log_partition(emissions, mask, transitions)
    return (score - log_z).mean()


def _sequence_score(emissions, tags, mask, transitions):
    tags = tags.long()
    maskf = mask.to(torch.float32)
    em = torch.take_along_dim(emissions, tags[..., None], dim=-1)[..., 0]  # (B, L)
    em_score = (em * maskf).sum(dim=1)
    trans = transitions[tags[:, :-1], tags[:, 1:]]  # (B, L-1)
    trans_score = (trans * maskf[:, 1:]).sum(dim=1)
    return em_score + trans_score


def _log_partition(emissions, mask, transitions):
    L = emissions.shape[1]
    keep = mask.bool()
    alpha = emissions[:, 0, :]  # (B, T)
    for t in range(1, L):
        # next_alpha[j] = logsumexp_i(alpha[i] + trans[i, j]) + em[j]
        scores = alpha[:, :, None] + transitions[None, :, :]
        new = torch.logsumexp(scores, dim=1) + emissions[:, t]
        alpha = torch.where(keep[:, t, None], new, alpha)
    return torch.logsumexp(alpha, dim=-1)


def crf_viterbi_decode(
    emissions: torch.Tensor, mask: torch.Tensor, transitions: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Best tag path per sequence. Returns (tags (B, L) int64, score (B,)).

    Invalid positions carry the last valid tag forward (callers mask them).
    """
    B, L, T = emissions.shape
    keep = mask.bool()
    ident = torch.arange(T, device=emissions.device)[None, :].expand(B, T)
    alpha = emissions[:, 0, :]
    bps = []
    for t in range(1, L):
        scores = alpha[:, :, None] + transitions[None, :, :]  # (B, T, T)
        best_prev = torch.argmax(scores, dim=1)  # (B, T), first maximal index
        new = scores.amax(dim=1) + emissions[:, t]
        k = keep[:, t, None]
        alpha = torch.where(k, new, alpha)
        # a masked step's backpointer is the identity
        bps.append(torch.where(k, best_prev, ident))
    best_last = torch.argmax(alpha, dim=-1)  # (B,)
    best_score = alpha.amax(dim=-1)
    tags = [best_last]
    for bp in reversed(bps):
        tags.append(torch.take_along_dim(bp, tags[-1][:, None], dim=1)[:, 0])
    return torch.stack(tags[::-1], dim=1), best_score
