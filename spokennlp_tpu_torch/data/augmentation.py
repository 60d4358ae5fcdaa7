"""Topic-structure data augmentation (DA) and TSSP pair-order labels.

The port's own copy of ``spokennlp_tpu/data/augmentation.py`` (same behaviour; imports
only the port, numpy and the standard library).

Host-side reimplementation of the reference's augmentation pipeline
(reference: emnlp2023-topic_segmentation/src/ts_sentence_seq_labeling.py:
366-716):

1. ``shuffle_and_replace_topics`` — shuffle the document's topics; with
   probability 0.5 (and when other documents exist) replace individual topics
   by random topics from other documents, each with probability 0.5
   (:389-459).
2. ``shuffle_intra_topic`` — shuffle sentences within each topic, keeping the
   topic-final sentence in place, and emit per-sentence TSSP pair-order
   labels under 5 ablation schemes (:461-588).
3. ``augment_documents`` — the full prepare_augmented_data walk (:605-716).

The DA document is then windowed with the ANCHOR document's token boundaries
(reference slices da ids with the anchor window's [left:right) — :824-825),
implemented in :func:`pair_windows`.

All randomness comes from a caller-provided ``np.random.Generator`` — the
reference uses Python ``random`` inside datasets.map; metric-level (not
bitwise) parity is the goal.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from spokennlp_tpu_torch.configs import WindowingConfig
from spokennlp_tpu_torch.data.windowing import IGNORE, Window, _flatten_doc

LABEL_EOP = 0
LABEL_O = 1

# TSSP pair-order classes (tssp_ablation="none", :501-511):
PAIR_NSP_SAME_TOPIC = 0  # b is the next sentence of a, same topic
PAIR_NOT_NSP_SAME_TOPIC = 1  # b is not the next sentence of a, same topic
PAIR_NEW_TOPIC = 2  # b starts a new topic


@dataclasses.dataclass
class DaDoc:
    """An augmented document aligned to its anchor."""

    sent_token_ids: List[List[int]]
    sent_labels: List[int]
    pair_orders: List[int]
    replaced: bool


def _topic_spans(sent_labels: Sequence[int]) -> List[tuple]:
    """[(start_sent, end_sent)] per topic; end is inclusive and is the B-EOP
    sentence (trailing unlabeled sentences are NOT part of any topic, matching
    the reference which derives spans only from B-EOP indices, :628-631)."""
    ends = [i for i, l in enumerate(sent_labels) if l == LABEL_EOP]
    starts = [0] + [e + 1 for e in ends[:-1]]
    return list(zip(starts, ends))


def shuffle_and_replace_topics(
    doc_index: int,
    docs: Sequence[Dict],
    rng: np.random.Generator,
    p_replace_doc: float = 0.5,
    p_replace_topic: float = 0.5,
):
    """Stage 1: topic-level shuffle + cross-document replacement.

    Returns (sent_token_ids, sent_labels, pair_orders, replaced, topic_orders)
    where topic_orders[i] is the original index of the i-th output topic, or
    -1 when it was replaced from another document (:387-401).
    """
    doc = docs[doc_index]
    spans = _topic_spans(doc["labels"])
    n_topics = len(spans)
    order = list(range(n_topics))
    rng.shuffle(order)
    topic_orders = list(order)

    out_sents: List[List[int]] = []
    out_labels: List[int] = []
    out_pairs: List[int] = []
    replaced = False

    do_replace = rng.random() > p_replace_doc and len(docs) > 1
    for i, t in enumerate(order):
        if do_replace and rng.random() > p_replace_topic:
            replaced = True
            topic_orders[i] = -1
            other_choices = [j for j in range(len(docs)) if j != doc_index]
            src_doc = docs[int(rng.choice(other_choices))]
            src_spans = _topic_spans(src_doc["labels"])
            if not src_spans:
                src_spans = [(0, len(src_doc["labels"]) - 1)]
            s, e = src_spans[int(rng.integers(len(src_spans)))]
            sents = src_doc["sent_token_ids"][s : e + 1]
            labels = src_doc["labels"][s : e + 1]
        else:
            s, e = spans[t]
            sents = doc["sent_token_ids"][s : e + 1]
            labels = doc["labels"][s : e + 1]
        for j, (sent, lab) in enumerate(zip(sents, labels)):
            out_sents.append(list(sent))
            out_labels.append(lab)
            out_pairs.append(PAIR_NEW_TOPIC if j == 0 else PAIR_NSP_SAME_TOPIC)
    return out_sents, out_labels, out_pairs, replaced, topic_orders


def shuffle_intra_topic(
    sent_token_ids: List[List[int]],
    sent_labels: List[int],
    rng: np.random.Generator,
    tssp_ablation: str = "none",
    topic_orders: Optional[List[int]] = None,
):
    """Stage 2: shuffle sentences inside each topic (topic-final sentence
    stays) and emit TSSP labels (:461-588).

    Sentence indices here refer to the STAGE-1 document; ``sent_index == 0``
    checks in the nsp/sso schemes refer to that document's first sentence.
    """
    spans = _topic_spans(sent_labels)
    out_sents: List[List[int]] = []
    out_labels: List[int] = []
    out_pairs: List[int] = []

    for ti, (start, end) in enumerate(spans):
        idx = list(range(start, end))
        rng.shuffle(idx)
        idx.append(end)  # topic-final sentence is pinned

        for j, si in enumerate(idx):
            out_sents.append(list(sent_token_ids[si]))
            if tssp_ablation == "none":
                if j == 0:
                    p = PAIR_NEW_TOPIC
                else:
                    p = (
                        PAIR_NSP_SAME_TOPIC
                        if idx[j - 1] == si - 1
                        else PAIR_NOT_NSP_SAME_TOPIC
                    )
            elif tssp_ablation == "wo_intra_topic":
                p = 1 if j == 0 else 0
            elif tssp_ablation == "wo_inter_topic":
                if j == 0:
                    if ti == 0:
                        p = 1
                    elif (
                        topic_orders is None
                        or topic_orders[ti - 1] == -1
                        or topic_orders[ti - 1] + 1 != topic_orders[ti]
                    ):
                        p = 1
                    else:
                        p = 0 if si == 0 else 1
                else:
                    p = 0 if idx[j - 1] == si - 1 else 1
            elif tssp_ablation == "sso":
                if j == 0:
                    if ti == 0:
                        p = 2
                    elif (
                        topic_orders is None
                        or topic_orders[ti - 1] == -1
                        or topic_orders[ti - 1] + 1 != topic_orders[ti]
                    ):
                        p = 2
                    else:
                        p = 0 if si == 0 else 2
                else:
                    if idx[j - 1] == si - 1:
                        p = 0
                    elif idx[j - 1] == si + 1:
                        p = 1
                    else:
                        p = 2
            elif tssp_ablation == "sso_and_intra_topic":
                if j == 0:
                    p = 2
                else:
                    if idx[j - 1] == si - 1:
                        p = 0
                    elif idx[j - 1] == si + 1:
                        p = 1
                    else:
                        p = 2
            else:
                raise ValueError(f"unrecognized tssp_ablation {tssp_ablation!r}")
            out_pairs.append(p)
        # topic keeps O...O B-EOP labels (:492)
        out_labels.extend([LABEL_O] * (len(idx) - 1) + [LABEL_EOP])
    return out_sents, out_labels, out_pairs


def augment_documents(
    docs: Sequence[Dict],
    rng: np.random.Generator,
    tssp_ablation: str = "none",
) -> List[DaDoc]:
    """Full DA pipeline over a batch of documents (:605-716)."""
    out = []
    for i in range(len(docs)):
        s1_sents, s1_labels, _, replaced, topic_orders = shuffle_and_replace_topics(
            i, docs, rng
        )
        s2_sents, s2_labels, s2_pairs = shuffle_intra_topic(
            s1_sents, s1_labels, rng, tssp_ablation, topic_orders
        )
        out.append(
            DaDoc(
                sent_token_ids=s2_sents,
                sent_labels=s2_labels,
                pair_orders=s2_pairs,
                replaced=replaced,
            )
        )
    return out


def pair_windows(
    anchor_windows: Sequence[Window],
    da_doc: DaDoc,
    cfg: WindowingConfig,
    example_id: int,
) -> List[Window]:
    """Build the DA window for each anchor window.

    The reference slices the DA token stream with the ANCHOR window's token
    boundaries (:824-825) and does NOT mask the DA window's last BOS. Here the
    anchor window's span is recovered from its content length and window
    order (windows are contiguous up to the shared-sentence overlap), so we
    re-derive [token_left, token_right) per anchor window and slice the DA
    stream identically.
    """
    flat, bos_pos, _ = _flatten_doc(da_doc.sent_token_ids, cfg)
    # token-level labels and pair orders on the DA stream
    tok_labels = np.full(len(flat), IGNORE, dtype=np.int32)
    tok_pairs = np.full(len(flat), IGNORE, dtype=np.int32)
    for si, pos in enumerate(bos_pos):
        if si < len(da_doc.sent_labels):
            tok_labels[pos] = da_doc.sent_labels[si]
            tok_pairs[pos] = da_doc.pair_orders[si]

    L = cfg.max_seq_length
    K = anchor_windows[0].sent_positions.shape[0] if anchor_windows else 0
    out: List[Window] = []
    for w in anchor_windows:
        tl, tr = w.token_span
        ids = [cfg.cls_token_id] + flat[tl:tr]
        ids = ids[:L]
        n = len(ids)
        labels = np.full(L, IGNORE, np.int32)
        sent_positions = np.zeros(K, np.int32)
        sent_mask = np.zeros(K, np.int32)
        eop_mask = np.zeros(K, np.int32)
        sent_lab = np.full(K, IGNORE, np.int32)
        sent_pair = np.full(K, IGNORE, np.int32)
        sent_ids_arr = np.full(K, -1, np.int32)
        k = 0
        # walk BOS positions inside the slice
        for si, pos in enumerate(bos_pos):
            if pos < tl or pos >= tr:
                continue
            win_pos = pos - tl + 1
            if win_pos >= L:
                break
            lab = int(tok_labels[pos])
            labels[win_pos] = lab
            if k < K:
                sent_positions[k] = win_pos
                sent_mask[k] = 1
                eop_mask[k] = 1 if lab != IGNORE else 0
                sent_lab[k] = lab
                sent_pair[k] = int(tok_pairs[pos])
                sent_ids_arr[k] = si
                k += 1
        input_ids = np.full(L, cfg.pad_token_id, np.int32)
        input_ids[:n] = np.asarray(ids, np.int32)
        attention_mask = np.zeros(L, np.int32)
        attention_mask[:n] = 1
        out.append(
            Window(
                example_id=example_id,
                input_ids=input_ids,
                attention_mask=attention_mask,
                token_type_ids=np.zeros(L, np.int32),
                labels=labels,
                sent_positions=sent_positions,
                sent_mask=sent_mask,
                eop_mask=eop_mask,
                sent_labels=sent_lab,
                pair_orders=sent_pair,
                sent_ids=sent_ids_arr,
                token_span=(tl, tr),
            )
        )
    return out
