"""CSSL (contrastive semantic similarity learning) and the sentence features
of the topic-segmentation heads.

Counterpart of ``spokennlp_tpu/objectives/cssl.py``, with the same
fixed-shape formulation: EOP features are a gather at sentence (BOS)
positions, topic ids a masked exclusive cumsum over the padded (B, K) grid,
and the list-mode sampling is done on the host (``data/cssl_sampling.py``),
so the device reads index tensors.

Cosine normalisation is x * rsqrt(sum x^2 + eps^2): x / max(|x|, eps) has a
NaN gradient at a zero row.
"""

from __future__ import annotations

import torch

IGNORE = -100
LABEL_EOP = 0
LABEL_O = 1


def gather_sentence_features(seq_output: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Hidden states at sentence (BOS) positions.

    seq_output: (B, L, H); positions: (B, K) int -> (B, K, H).
    """
    return torch.take_along_dim(seq_output, positions.long()[..., None], dim=1)


def topic_segment_ids(eop_labels: torch.Tensor, eop_mask: torch.Tensor):
    """A global topic id for every valid EOP slot: ids grow within an example
    after each label-0 (B-EOP) sentence and continue across examples; an
    example whose last valid label is O still closes its trailing topic.

    eop_labels (B, K) label ids at eop slots; eop_mask (B, K) 1 on valid
    slots, packed left. Returns (ids (B, K) int64, 0 where invalid; valid
    (B, K) bool; the batch's topic count).
    """
    valid = eop_mask.bool()
    is_eop = (valid & (eop_labels == LABEL_EOP)).long()
    within = torch.cumsum(is_eop, dim=1) - is_eop

    n_valid = valid.long().sum(dim=1)
    last_idx = (n_valid - 1).clamp_min(0)
    last_label = torch.take_along_dim(eop_labels, last_idx[:, None], dim=1)[:, 0]
    trailing_open = (n_valid > 0) & (last_label == LABEL_O)
    n_topics = is_eop.sum(dim=1) + trailing_open.long()

    offsets = torch.cumsum(n_topics, dim=0) - n_topics
    ids = torch.where(valid, within + offsets[:, None], 0)
    return ids, valid, n_topics.sum()


def _l2_normalize(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt((x * x).sum(dim=-1, keepdim=True) + 1e-16)


def pairwise_similarity(x: torch.Tensor, y: torch.Tensor, temp: float) -> torch.Tensor:
    """Cosine similarity / temp, or the raw dot product when temp == 0."""
    x, y = x.float(), y.float()
    if temp == 0:
        return x @ y.T
    return (_l2_normalize(x) @ _l2_normalize(y).T) / temp


def eop_matrix_cl_loss(
    eop_features: torch.Tensor,
    eop_labels: torch.Tensor,
    eop_mask: torch.Tensor,
    temp: float,
) -> torch.Tensor:
    """Full-matrix InfoNCE with same-topic positives.

    eop_features (B, K, H). A scalar; 0 when the batch has at most 2 EOPs or
    a single topic.
    """
    B, K, H = eop_features.shape
    ids, valid, _ = topic_segment_ids(eop_labels, eop_mask)
    feats = eop_features.reshape(B * K, H)
    flat_ids, flat_valid = ids.reshape(-1), valid.reshape(-1)
    M = B * K

    sim = pairwise_similarity(feats, feats, temp)
    pair_valid = flat_valid[:, None] & flat_valid[None, :]
    same = (flat_ids[:, None] == flat_ids[None, :]) & pair_valid
    eye = torch.eye(M, dtype=torch.bool, device=feats.device)
    pos_mask = same & ~eye
    neg_mask = pair_valid & ~same

    exp_sim = torch.exp(sim)
    numerator = torch.where(pos_mask, exp_sim, 0.0).sum(dim=0)
    denominator = numerator + torch.where(neg_mask, exp_sim, 0.0).sum(dim=0)

    prob = numerator / denominator.clamp_min(1e-12)
    use = flat_valid & (numerator > 0)
    losses = -torch.log(prob.clamp_min(1e-12))
    loss = torch.where(use, losses, 0.0).sum() / use.sum().clamp_min(1)

    n_eops = flat_valid.sum()
    max_topic = torch.where(flat_valid, flat_ids, 0).max()
    gate = (n_eops > 2) & (max_topic > 0)
    return torch.where(gate, loss, 0.0)


def list_cl_loss(
    eop_features: torch.Tensor,
    anchor_indices: torch.Tensor,
    positive_indices: torch.Tensor,
    negative_indices: torch.Tensor,
    anchor_valid: torch.Tensor,
    temp: float,
) -> torch.Tensor:
    """List-mode InfoNCE over host-sampled indices into the flattened
    (B*K, H) features: anchors (A,), positives (P, A), negatives (N, A),
    anchor_valid (A,) 1 on live anchors."""
    B, K, H = eop_features.shape
    feats = eop_features.reshape(B * K, H).float()
    anchors = feats[anchor_indices.long()]  # (A, H)

    def sims(idx):  # (R, A) -> (R, A)
        other = feats[idx.long()]  # (R, A, H)
        if temp == 0:
            return (anchors[None] * other).sum(-1)
        return (_l2_normalize(anchors)[None] * _l2_normalize(other)).sum(-1) / temp

    numerator = torch.exp(sims(positive_indices)).sum(dim=0)
    denominator = numerator + torch.exp(sims(negative_indices)).sum(dim=0)
    losses = -torch.log((numerator / denominator.clamp_min(1e-12)).clamp_min(1e-12))
    av = anchor_valid.float()
    return (losses * av).sum() / av.sum().clamp_min(1.0)


def eop_pair_cosine_similarity(
    eop_features: torch.Tensor,
    eop_labels: torch.Tensor,
    eop_mask: torch.Tensor,
    temp: float,
):
    """Cosine similarity between each labelled sentence and the next one.

    Valid slots are compacted first (a stable sort keeps their order), slot
    k pairs with k + 1 (wrapping to 0 after the last), and the similarities
    go back to the original slots. Returns (sims, labels), both (B, K) with
    IGNORE on invalid slots.
    """
    B, K, H = eop_features.shape
    valid = eop_mask.bool()
    n_valid = valid.long().sum(dim=1)
    idx = torch.arange(K, device=eop_features.device)[None, :]

    order = torch.argsort((~valid).int(), dim=1, stable=True)
    feats_c = torch.take_along_dim(eop_features, order[..., None], dim=1)
    nxt = torch.where(idx + 1 < n_valid[:, None], idx + 1, 0)
    next_feats = torch.take_along_dim(feats_c, nxt[..., None], dim=1)

    cos_c = (_l2_normalize(feats_c.float()) * _l2_normalize(next_feats.float())).sum(-1)
    if temp != 0:
        cos_c = cos_c / temp
    cos = torch.take_along_dim(cos_c, torch.argsort(order, dim=1), dim=1)

    sims = torch.where(valid, cos, float(IGNORE))
    labels = torch.where(valid, eop_labels, IGNORE)
    return sims, labels
