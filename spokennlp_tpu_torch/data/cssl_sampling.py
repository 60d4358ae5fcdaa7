"""Host-side positive/negative sampling for list-mode CSSL.

The port's own copy of ``spokennlp_tpu/data/cssl_sampling.py`` (same behaviour; imports
only the port, numpy and the standard library).

The reference samples contrastive pairs inside the torch forward pass with
Python ``random`` over ragged label lists (reference: emnlp2023-topic_
segmentation/src/models/modules/cssl.py:118-228). The sampling depends only
on the batch's labels and an RNG, so in the TPU design it moves into the data
pipeline: this module emits fixed-shape index tensors the jitted loss gathers
from (objectives/cssl.py:list_cl_loss).

Index spaces: "ordinal" = position in the packed sequence of valid EOPs across
the batch (the reference's space); "flat" = b * K + k into the (B, K) feature
grid the device actually holds. Host converts ordinal -> flat.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

IGNORE = -100
LABEL_EOP = 0
LABEL_O = 1


def batch_topic_structure(eop_labels: np.ndarray, eop_mask: np.ndarray):
    """Walk the batch and recover the reference's cl_segment_ids.

    Returns (flat_indices, segment_ids): for every valid EOP in batch order,
    its flat (b*K+k) feature index and its global topic id
    (reference: cssl.py:250-262).
    """
    B, K = eop_labels.shape
    flat_indices: List[int] = []
    segment_ids: List[int] = []
    seg_id = 0
    for b in range(B):
        example_labels = []
        for k in range(K):
            if eop_mask[b, k]:
                flat_indices.append(b * K + k)
                example_labels.append(int(eop_labels[b, k]))
        if not example_labels:
            continue
        for lab in example_labels:
            segment_ids.append(seg_id)
            if lab == LABEL_EOP:
                seg_id += 1
        if example_labels[-1] == LABEL_O:
            seg_id += 1
    return np.asarray(flat_indices, dtype=np.int32), np.asarray(segment_ids, dtype=np.int32)


def build_cssl_list_indices(
    eop_labels: np.ndarray,
    eop_mask: np.ndarray,
    anchor_level: str,
    positive_k: int,
    negative_k: int,
    rng: np.random.Generator,
    max_anchors: int,
) -> Dict[str, np.ndarray]:
    """Build fixed-shape anchor/positive/negative index tensors.

    Replicates eop_level_list_cl_loss (cssl.py:118-167) and
    eot_level_list_cl_loss (cssl.py:169-228): positives walk backwards within
    the anchor's topic with a random in-topic fallback; negatives walk
    forwards into the following topics with a random fallback.

    Returns dict with:
      anchor_indices (A,), positive_indices (P, A), negative_indices (N, A),
      anchor_valid (A,) — all flat indices into the (B*K) feature grid,
      zero-padded past the live anchors.
    """
    flat_idx, seg_ids = batch_topic_structure(eop_labels, eop_mask)
    total_eop = len(seg_ids)

    A = max_anchors
    out = {
        "anchor_indices": np.zeros(A, dtype=np.int32),
        "positive_indices": np.zeros((positive_k, A), dtype=np.int32),
        "negative_indices": np.zeros((negative_k, A), dtype=np.int32),
        "anchor_valid": np.zeros(A, dtype=np.int32),
    }
    # the reference's gate: need > 2 eops and >= 2 topics (cssl.py:263-264)
    if total_eop <= 2 or seg_ids[-1] == 0:
        return out

    n_topics = int(seg_ids[-1]) + 1
    bot = [int(np.argmax(seg_ids == t)) for t in range(n_topics)]  # first ordinal of topic
    eot = [bot[t + 1] - 1 for t in range(n_topics - 1)] + [total_eop - 1]

    if anchor_level == "eop_list":
        anchor_ordinals = list(range(total_eop))
        anchor_topics = [int(seg_ids[o]) for o in anchor_ordinals]
    elif anchor_level == "eot_list":
        anchor_ordinals = list(eot)
        anchor_topics = list(range(n_topics))
    else:
        raise ValueError(f"unsupported anchor_level {anchor_level!r}")

    pos_ordinals = [[] for _ in range(positive_k)]
    neg_ordinals = [[] for _ in range(negative_k)]
    for o, t in zip(anchor_ordinals, anchor_topics):
        start_id, end_id = bot[t], eot[t]
        # positives: walk backwards from the anchor (eop_list) / from the topic
        # end (eot_list); fallback = random in-topic (excluding the end) or the
        # end itself when the topic is a singleton.
        choice_ids = list(range(start_id, end_id)) or [end_id]
        pos = o if anchor_level == "eop_list" else end_id
        for i in range(positive_k):
            pos -= 1
            if pos < start_id:
                pos = int(rng.choice(choice_ids))
            pos_ordinals[i].append(pos)
        # negatives: walk forwards past the topic end; fallback = random among
        # the ordinals after this topic, or the first topic when none remain.
        choice_ids = list(range(end_id + 1, eot[-1] + 1))
        if not choice_ids:
            choice_ids = list(range(bot[0], bot[1]))
        neg = end_id
        for i in range(negative_k):
            neg += 1
            if neg >= total_eop:
                neg = int(rng.choice(choice_ids))
            neg_ordinals[i].append(neg)

    n_anchor = min(len(anchor_ordinals), A)
    out["anchor_indices"][:n_anchor] = flat_idx[np.asarray(anchor_ordinals[:n_anchor])]
    out["anchor_valid"][:n_anchor] = 1
    for i in range(positive_k):
        out["positive_indices"][i, :n_anchor] = flat_idx[
            np.asarray(pos_ordinals[i][:n_anchor])
        ]
    for i in range(negative_k):
        out["negative_indices"][i, :n_anchor] = flat_idx[
            np.asarray(neg_ordinals[i][:n_anchor])
        ]
    return out
