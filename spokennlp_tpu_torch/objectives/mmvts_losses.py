"""MMVTS objectives: weighted ts CE + modality alignment + topic contrastive,
on PyTorch.

Counterpart of ``spokennlp_tpu/objectives/mmvts_losses.py`` (the reference
LossLayer stack, mmvts/src/models/modules/loss_layer.py:7-118 and
contrastive_learning_layer.py:26-295). Every loss runs on the padded (B, K)
clip grid with a mask, as in JAX; the aux keys are JAX's.
``build_topic_cl_list_indices`` is the port's own copy of JAX's host
function: the same ``np.random.Generator`` draws in the same order, so one
seed gives the same indices.

Label convention (MMVTS): clip label 1 = END of topic (config.label_eot = 1)
— inverted from the emnlp2023 B-EOP=0 scheme.

Modality InfoNCE and the matrix topic CL take their negatives across the
whole batch, so the loss of a batch split over data-parallel ranks would
differ: the losses take no ``dp`` argument.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from spokennlp_tpu_torch.ops.losses import cross_entropy_with_ignore, ts_class_weights

IGNORE = -100
EPS = 1e-8
LABEL_EOT = 1


def _l2_normalize(x: torch.Tensor) -> torch.Tensor:
    """Zero-safe cosine normalisation: ``x * rsqrt(sum(x^2) + eps^2)``.

    ``x / (norm(x) + eps)`` has a NaN gradient at x == 0, and exactly-zero
    rows are real here (padded clips carry zero features; LayerNorm of a
    constant vector is 0 at init); the rsqrt of the eps'd square sum is
    finite everywhere."""
    sq = torch.sum(x * x, dim=-1, keepdim=True)
    return x * torch.rsqrt(sq + EPS * EPS)


def _masked_mean(losses: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    n = valid.sum().clamp_min(1)
    return torch.where(valid, losses, 0.0).sum() / n


def ts_loss(logits: torch.Tensor, clip_labels: torch.Tensor, clip_mask: torch.Tensor,
            weight_label_zero: float = 0.5) -> torch.Tensor:
    """CE over valid clips (loss_layer.py:14-23)."""
    labels = torch.where(clip_mask.bool(), clip_labels, IGNORE)
    return cross_entropy_with_ignore(logits, labels,
                                     class_weights=ts_class_weights(weight_label_zero))


def modality_cl_loss(feats_a: torch.Tensor, feats_b: torch.Tensor, clip_mask: torch.Tensor,
                     temp: float = 0.1) -> torch.Tensor:
    """Clip-aligned InfoNCE: matching clips across modalities are positives
    (contrastive_learning_layer.py:26-37), valid clips flattened batch-wide."""
    B, K, H = feats_a.shape
    an = _l2_normalize(feats_a.reshape(B * K, H).float())
    bn = _l2_normalize(feats_b.reshape(B * K, H).float())
    valid = clip_mask.reshape(B * K).bool()
    sim = (an @ bn.T) / temp
    exp_sim = torch.where(valid[None, :], torch.exp(sim), 0.0)
    numerator = torch.exp(torch.sum(an * bn, dim=-1) / temp) + EPS
    denominator = exp_sim.sum(dim=1) + EPS
    return _masked_mean(-torch.log(numerator / denominator), valid)


def _flat_topic_ids(clip_labels: torch.Tensor, clip_mask: torch.Tensor):
    """Global topic ids over the flattened valid clips; each sample's last
    valid clip is forced to close its topic (TopicContrastiveLearning.
    get_valid_labels:45-58)."""
    B, K = clip_labels.shape
    valid = clip_mask.bool()
    n_valid = valid.int().sum(dim=1)
    last_idx = (n_valid - 1).clamp_min(0)
    is_last = (torch.arange(K, device=valid.device)[None, :] == last_idx[:, None]) & valid
    labels = torch.where(is_last, LABEL_EOT, clip_labels)
    is_eot = (valid & (labels == LABEL_EOT)).long()
    within = torch.cumsum(is_eot, dim=1) - is_eot
    n_topics = is_eot.sum(dim=1)
    offsets = torch.cumsum(n_topics, dim=0) - n_topics
    ids = torch.where(valid, within + offsets[:, None], -1)
    return ids, valid


def topic_cl_matrix_loss(fused: torch.Tensor, clip_labels: torch.Tensor,
                         clip_mask: torch.Tensor, temp: float = 0.1) -> torch.Tensor:
    """Matrix-mode topic contrastive loss (matrix_type_loss:85-101):
    positives are same-topic pairs, the denominator all valid pairs but the
    diagonal; mean of -log((num + eps) / (den + eps)) over valid rows."""
    B, K, H = fused.shape
    ids, valid = _flat_topic_ids(clip_labels, clip_mask)
    flat_ids, flat_valid = ids.reshape(-1), valid.reshape(-1)
    fn = _l2_normalize(fused.reshape(B * K, H).float())
    sim = (fn @ fn.T) / temp
    eye = torch.eye(B * K, dtype=torch.bool, device=fused.device)
    pair_valid = flat_valid[:, None] & flat_valid[None, :] & ~eye
    same = pair_valid & (flat_ids[:, None] == flat_ids[None, :])
    exp_sim = torch.exp(sim)
    numerator = torch.where(same, exp_sim, 0.0).sum(dim=1) + EPS
    denominator = torch.where(pair_valid, exp_sim, 0.0).sum(dim=1) + EPS
    return _masked_mean(-torch.log(numerator / denominator), flat_valid)


def build_topic_cl_list_indices(
    clip_labels: np.ndarray,
    clip_mask: np.ndarray,
    pos_k: int,
    neg_k: int,
    choice: str = "random",
    rng=None,
):
    """Host-side anchor/pos/neg sampling for list-mode topic CL (reference:
    contrastive_learning_layer.py list_type_loss + select_pos/neg_features,
    :165-295), in the data pipeline; the device loss is a fixed-shape gather.

    Each sample's last valid clip closes its topic; anchors are every clip
    of every topic with more than one clip; positives come from the
    anchor's topic ("random" or distance-ordered "near"), negatives from
    other topics ("random", or the following / preceding topics for
    "near"), both padded by repetition. A batch with fewer than 2 topics has
    no valid anchor (the reference returns a 0 loss).

    Returns numpy arrays of flat indices into the (B*K) clip grid:
    anchor_valid (B*K,), pos (pos_k, B*K), neg (neg_k, B*K).
    """
    B, K = clip_labels.shape
    M = B * K
    anchor_valid = np.zeros(M, np.int32)
    pos = np.zeros((pos_k, M), np.int32)
    neg = np.zeros((neg_k, M), np.int32)
    rng = rng or np.random.default_rng(0)

    # flatten valid clips in order; force each sample's last valid clip = EOT
    flat_pos: list = []  # valid-seq index -> flat (B*K) index
    labels_seq: list = []
    for b in range(B):
        ks = [k for k in range(K) if clip_mask[b, k]]
        for j, k in enumerate(ks):
            flat_pos.append(b * K + k)
            labels_seq.append(LABEL_EOT if j == len(ks) - 1 else int(clip_labels[b, k]))
    if not labels_seq:
        return {"anchor_valid": anchor_valid, "pos": pos, "neg": neg}

    # topics over the valid sequence: [start, end) spans
    topics = []
    start = 0
    for i, lab in enumerate(labels_seq):
        if lab == LABEL_EOT:
            topics.append((start, i + 1))
            start = i + 1
    if len(topics) < 2:
        return {"anchor_valid": anchor_valid, "pos": pos, "neg": neg}

    def pad_pick(cands, n):
        cands = list(cands)
        while len(cands) < n:
            cands.append(cands[int(rng.integers(0, len(cands)))])
        if choice == "random":
            sel = rng.permutation(len(cands))[:n]
            return [cands[i] for i in sel]
        return cands[:n]

    for t_idx, (s, e) in enumerate(topics):
        if e - s < 2:
            continue  # single-clip topic: no positives, not an anchor
        for a in range(s, e):
            fa = flat_pos[a]
            anchor_valid[fa] = 1
            if choice == "near":
                left = list(range(a - 1, s - 1, -1))
                right = list(range(a + 1, e))
                merged = []
                for x, y in zip(left, right):
                    merged += [x, y]
                merged += right[len(left):] if len(left) < len(right) else left[len(right):]
                pos_c = merged
            else:
                pos_c = list(range(s, a)) + list(range(a + 1, e))
            for i, idx in enumerate(pad_pick(pos_c, pos_k)):
                pos[i, fa] = flat_pos[idx]
            if choice == "near":
                if t_idx < len(topics) - 1:
                    neg_c = list(range(topics[t_idx + 1][0], topics[-1][1]))
                else:
                    neg_c = list(range(topics[t_idx - 1][1] - 1, -1, -1))
            else:
                neg_c = [i for o, (os_, oe) in enumerate(topics) if o != t_idx
                         for i in range(os_, oe)]
            for i, idx in enumerate(pad_pick(neg_c, neg_k)):
                neg[i, fa] = flat_pos[idx]
    return {"anchor_valid": anchor_valid, "pos": pos, "neg": neg}


def topic_cl_list_loss(fused: torch.Tensor, indices: Dict[str, torch.Tensor], temp: float = 0.1,
                       fct: str = "simcse") -> torch.Tensor:
    """Device side of list-mode topic CL (anchor_cl_loss, :127-163): per
    anchor, "simcse" = -log(sum exp(pos/T) / (sum exp(pos/T) + sum
    exp(neg/T)) + eps); "ce" = BCE-with-logits on the raw cosines (1 =
    positive). Mean over valid anchors; 0 when none."""
    B, K, H = fused.shape
    fn = _l2_normalize(fused.reshape(B * K, H).float())
    valid = indices["anchor_valid"].bool()

    def sims(idx):  # (n, M) -> (n, M) cosine per anchor
        return torch.sum(fn[None, :, :] * fn[idx.long()], dim=-1)

    pos_sim, neg_sim = sims(indices["pos"]), sims(indices["neg"])
    if fct == "simcse":
        pos_e = torch.exp(pos_sim / temp).sum(dim=0)
        neg_e = torch.exp(neg_sim / temp).sum(dim=0)
        losses = -torch.log(pos_e / (pos_e + neg_e) + EPS)
    elif fct == "ce":
        def bce(sim, label):
            return torch.log1p(torch.exp(-sim)) + (1 - label) * sim

        losses = (bce(pos_sim, 1.0).sum(dim=0) + bce(neg_sim, 0.0).sum(dim=0)) / (
            pos_sim.shape[0] + neg_sim.shape[0])
    else:
        raise ValueError(fct)
    return _masked_mean(losses, valid)


PAIR_FEATS = {"av": ("audio", "vis"), "at": ("audio", "text"), "tv": ("text", "vis")}


def mmvts_total_loss(
    cfg,
    outputs: Dict[str, torch.Tensor],
    clip_labels: torch.Tensor,
    clip_mask: torch.Tensor,
    *,
    weight_label_zero: float = 0.5,
    ts_lw: float = 1.0,
    do_modality_cl: bool = False,
    modality_cl_lw: float = 1.0,
    align_pairs: Optional[Dict[str, float]] = None,
    align_before_fuse: bool = True,
    cl_temp: float = 0.1,
    do_topic_mm_cl: bool = False,
    topic_mm_cl_lw: float = 1.0,
    topic_cl_type: str = "matrix",
    topic_cl_fct: str = "simcse",
    topic_cl_indices: Optional[Dict[str, torch.Tensor]] = None,
):
    """The composite loss (loss_layer.py:68-118) -> (total, aux).
    ``align_pairs`` maps pair names ("av", "at", "tv") to weights."""
    aux: Dict[str, torch.Tensor] = {}
    total = ts_lw * ts_loss(outputs["logits"], clip_labels, clip_mask, weight_label_zero)
    aux["ts_loss"] = total

    if do_modality_cl:
        feats = outputs["projected"] if align_before_fuse else outputs["features"]
        m_loss = 0.0
        for pair, w in (align_pairs or {}).items():
            a, b = PAIR_FEATS[pair]
            if a in feats and b in feats:
                loss = w * modality_cl_loss(feats[a], feats[b], clip_mask, cl_temp)
                aux[f"{pair}_cl_loss"] = loss
                m_loss = m_loss + loss
        m_loss = modality_cl_lw * m_loss
        aux["modality_cl_loss"] = torch.as_tensor(m_loss, dtype=torch.float32,
                                                  device=clip_mask.device)
        total = total + m_loss

    if do_topic_mm_cl:
        if topic_cl_type == "list":
            if topic_cl_indices is None:
                raise ValueError("list-mode topic CL needs host-sampled indices "
                                 "(build_topic_cl_list_indices in the data pipeline)")
            t_loss = topic_mm_cl_lw * topic_cl_list_loss(outputs["fused"], topic_cl_indices,
                                                         cl_temp, topic_cl_fct)
        else:
            t_loss = topic_mm_cl_lw * topic_cl_matrix_loss(outputs["fused"], clip_labels,
                                                           clip_mask, cl_temp)
        aux["topic_mm_cl_loss"] = t_loss
        total = total + t_loss

    if outputs.get("moe_loss") is not None:
        aux["moe_loss"] = outputs["moe_loss"]
        total = total + outputs["moe_loss"]

    aux["total_loss"] = total
    return total, aux
