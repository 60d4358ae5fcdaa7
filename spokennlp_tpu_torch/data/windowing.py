"""Self-adaptive sliding-window featurization (host side, pure functions).

The port's own copy of ``spokennlp_tpu/data/windowing.py`` (same behaviour; imports
only the port, numpy and the standard library).

Converts a document — a list of sentences with end-of-paragraph/topic labels —
into fixed-shape model windows. Reimplements the behavior of the reference's
window loop (reference: emnlp2023-topic_segmentation/src/
ts_sentence_seq_labeling.py:719-934; window emission and the
shared-sentence overlap rule at :814-918) as pure, unit-testable functions.

Semantics preserved:
  - every sentence is prefixed with a [BOS] marker token; the sentence's label
    lives at its BOS position, all other tokens carry ``ignore_id``.
  - a window is emitted once it reaches ``max_seq_length - 1`` content tokens
    (or at document end); a [CLS] is prepended and the result is truncated to
    ``max_seq_length`` then padded.
  - the label of the LAST sentence of every window is masked to ``ignore_id``;
    neighboring windows share that sentence (it reopens the next window), so
    each sentence is labeled exactly once across windows — except the final
    sentence of the document, which is never labeled (standard segmentation
    convention: the last boundary is trivial).
  - a single over-long sentence forms its own window, is truncated, and is NOT
    shared with the next window.

TPU-first divergence from the reference: instead of emitting scatter-index
tensors (extract_eop_segment_ids / eop_index_for_aggregate...), windows carry
padded **gather** index arrays (``eop_positions``/``eop_mask``,
``sent_positions``/``sent_mask``) so the device side does fixed-shape gathers
rather than scatter_reduce.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from spokennlp_tpu_torch.configs import WindowingConfig

IGNORE = -100


@dataclasses.dataclass
class Window:
    """One fixed-length model input window."""

    example_id: int
    input_ids: np.ndarray  # (L,) int32
    attention_mask: np.ndarray  # (L,) int32
    token_type_ids: np.ndarray  # (L,) int32
    labels: np.ndarray  # (L,) int32; sentence label at BOS positions, else IGNORE
    sent_positions: np.ndarray  # (K,) int32; positions of ALL BOS tokens in window
    sent_mask: np.ndarray  # (K,) int32; 1 for real sentences
    eop_mask: np.ndarray  # (K,) int32; 1 where the sentence has a live label
    sent_labels: np.ndarray  # (K,) int32; label at each BOS (IGNORE if masked)
    pair_orders: np.ndarray  # (K,) int32; TSSP pair-order label per sentence (or IGNORE)
    sent_ids: np.ndarray  # (K,) int32; sentence index within the document (-1 pad)
    token_span: tuple = (0, 0)  # [token_left, token_right) in the flat doc stream


def _flatten_doc(
    sent_token_ids: Sequence[Sequence[int]],
    cfg: WindowingConfig,
) -> tuple:
    """Flatten sentences into one token stream with BOS markers.

    Returns (flat_ids, bos_token_positions, last_token_positions).
    """
    flat: List[int] = []
    bos_pos: List[int] = []
    for sent in sent_token_ids:
        bos_pos.append(len(flat))
        flat.append(cfg.bos_token_id)
        flat.extend(int(t) for t in sent)
    # position of the last token of each sentence
    last_pos = [bos_pos[i + 1] - 1 for i in range(len(bos_pos) - 1)] + [len(flat) - 1]
    return flat, bos_pos, last_pos


def window_document(
    sent_token_ids: Sequence[Sequence[int]],
    sent_labels: Sequence[int],
    cfg: WindowingConfig,
    example_id: int = 0,
    max_sentences_per_window: Optional[int] = None,
    pair_orders: Optional[Sequence[int]] = None,
) -> List[Window]:
    """Split one document into overlapping fixed-length windows.

    Args:
      sent_token_ids: token ids per sentence, WITHOUT the BOS marker.
      sent_labels: per-sentence label ids (cfg.label_eop / cfg.label_o, or
        IGNORE for unlabeled sentences).
      cfg: windowing config.
      example_id: document id carried into each window for re-aggregation.
      max_sentences_per_window: K, the padded size of the per-sentence arrays.
        Defaults to cfg.max_seq_length // 2 (every sentence occupies >= 2
        tokens after the BOS marker... a BOS-only sentence occupies 1, so the
        hard upper bound max_seq_length is used when None and any sentence is
        empty).
      pair_orders: optional per-sentence TSSP pair-order labels (for DA docs).

    Returns:
      list of Window.
    """
    assert len(sent_token_ids) == len(sent_labels)
    n_sent = len(sent_token_ids)
    if n_sent == 0:
        return []
    L = cfg.max_seq_length
    if max_sentences_per_window is None:
        if any(len(s) == 0 for s in sent_token_ids):
            max_sentences_per_window = L
        else:
            max_sentences_per_window = L // 2 + 1
    K = max_sentences_per_window

    flat, bos_pos, last_pos = _flatten_doc(sent_token_ids, cfg)
    total_tokens = len(flat)
    labels = list(sent_labels)
    pair_orders = list(pair_orders) if pair_orders is not None else [IGNORE] * n_sent

    windows: List[Window] = []
    token_left = 0
    sent_left = 0
    sent_i = 0
    while sent_i < n_sent:
        token_right = last_pos[sent_i] + 1
        if (token_right - token_left) >= L - 1 or token_right == total_tokens:
            single_sentence = sent_i == sent_left
            # sentence span [sent_left, sent_i] inclusive
            window = _emit_window(
                flat,
                bos_pos,
                labels,
                pair_orders,
                token_left,
                token_right,
                sent_left,
                sent_i,
                cfg,
                K,
                example_id,
                mask_last=True,
            )
            windows.append(window)
            if single_sentence:
                token_left = token_right
                sent_left = sent_i + 1
                sent_i += 1
            elif token_right == total_tokens:
                sent_left = sent_i + 1
                sent_i += 1
                token_left = token_right
            else:
                # neighboring windows share the last sentence: it reopens the
                # next window and receives its label there.
                token_left = bos_pos[sent_i]
                sent_left = sent_i
        else:
            sent_i += 1
    return windows


def _emit_window(
    flat: List[int],
    bos_pos: List[int],
    labels: List[int],
    pair_orders: List[int],
    token_left: int,
    token_right: int,
    sent_left: int,
    sent_last: int,
    cfg: WindowingConfig,
    K: int,
    example_id: int,
    mask_last: bool,
) -> Window:
    L = cfg.max_seq_length
    ids = [cfg.cls_token_id] + flat[token_left:token_right]
    ids = ids[:L]
    n = len(ids)

    token_labels = np.full(L, IGNORE, dtype=np.int32)
    sent_positions = np.zeros(K, dtype=np.int32)
    sent_mask = np.zeros(K, dtype=np.int32)
    eop_mask = np.zeros(K, dtype=np.int32)
    sent_lab = np.full(K, IGNORE, dtype=np.int32)
    sent_pair = np.full(K, IGNORE, dtype=np.int32)
    sent_ids_arr = np.full(K, -1, dtype=np.int32)

    k = 0
    for s in range(sent_left, sent_last + 1):
        pos_in_window = bos_pos[s] - token_left + 1  # +1 for CLS
        if pos_in_window >= L:
            break  # truncated away
        lab = labels[s]
        if mask_last and s == sent_last:
            lab = IGNORE
        token_labels[pos_in_window] = lab
        if k < K:
            sent_positions[k] = pos_in_window
            sent_mask[k] = 1
            eop_mask[k] = 1 if lab != IGNORE else 0
            sent_lab[k] = lab
            sent_pair[k] = pair_orders[s]
            sent_ids_arr[k] = s
            k += 1

    input_ids = np.full(L, cfg.pad_token_id, dtype=np.int32)
    input_ids[:n] = np.asarray(ids, dtype=np.int32)
    attention_mask = np.zeros(L, dtype=np.int32)
    attention_mask[:n] = 1
    token_type_ids = np.zeros(L, dtype=np.int32)

    return Window(
        example_id=example_id,
        input_ids=input_ids,
        attention_mask=attention_mask,
        token_type_ids=token_type_ids,
        labels=token_labels,
        sent_positions=sent_positions,
        sent_mask=sent_mask,
        eop_mask=eop_mask,
        sent_labels=sent_lab,
        pair_orders=sent_pair,
        sent_ids=sent_ids_arr,
        token_span=(token_left, token_right),
    )


def stack_windows(windows: Sequence[Window]) -> Dict[str, np.ndarray]:
    """Stack a list of Windows into a dict of batched arrays."""
    if not windows:
        raise ValueError("no windows to stack")
    out = {}
    for field in (
        "input_ids",
        "attention_mask",
        "token_type_ids",
        "labels",
        "sent_positions",
        "sent_mask",
        "eop_mask",
        "sent_labels",
        "pair_orders",
        "sent_ids",
    ):
        out[field] = np.stack([getattr(w, field) for w in windows])
    out["example_id"] = np.asarray([w.example_id for w in windows], dtype=np.int32)
    return out


def aggregate_window_predictions(
    window_example_ids: np.ndarray,
    window_labels: np.ndarray,
    window_scores: np.ndarray,
    num_examples: Optional[int] = None,
) -> List[Dict[str, np.ndarray]]:
    """Re-aggregate per-window token predictions into per-document sequences.

    Mirrors the reference's example-level aggregation (reference:
    ts_sentence_seq_labeling.py:1174-1191): for each window, positions with a
    live label (!= IGNORE) contribute one prediction, concatenated in window
    order per example id.

    Args:
      window_example_ids: (N,) document id per window.
      window_labels: (N, L) token-level labels (IGNORE = no prediction here).
      window_scores: (N, L, C) token-level logits or probabilities.
      num_examples: total number of documents (defaults to max id + 1).

    Returns:
      Per document: {"labels": (S,), "scores": (S, C)} where S is the number
      of labeled sentences in that document.
    """
    if num_examples is None:
        num_examples = int(window_example_ids.max()) + 1
    per_doc_labels: List[List[int]] = [[] for _ in range(num_examples)]
    per_doc_scores: List[List[np.ndarray]] = [[] for _ in range(num_examples)]
    for wi in range(window_labels.shape[0]):
        eid = int(window_example_ids[wi])
        live = window_labels[wi] != IGNORE
        per_doc_labels[eid].extend(window_labels[wi][live].tolist())
        per_doc_scores[eid].append(window_scores[wi][live])
    out = []
    for eid in range(num_examples):
        scores = (
            np.concatenate(per_doc_scores[eid], axis=0)
            if per_doc_scores[eid]
            else np.zeros((0, window_scores.shape[-1]), dtype=window_scores.dtype)
        )
        out.append(
            {
                "labels": np.asarray(per_doc_labels[eid], dtype=np.int32),
                "scores": scores,
            }
        )
    return out


def aggregate_gathered_predictions(
    window_example_ids: np.ndarray,
    window_sent_labels: np.ndarray,
    gathered_scores: np.ndarray,
    num_examples: Optional[int] = None,
) -> List[Dict[str, np.ndarray]]:
    """``aggregate_window_predictions`` for scores already gathered at
    ``sent_positions`` on device ((N, K, C) instead of (N, L, C)).

    Equivalence contract (window_document): the (L,)-label tensor is IGNORE
    everywhere except BOS positions, and ``sent_labels[k]`` carries exactly
    the label at ``sent_positions[k]`` (IGNORE when masked) with positions in
    ascending window order — so filtering K slots by ``sent_labels != IGNORE``
    yields the same predictions in the same order as scanning L tokens.
    """
    if num_examples is None:
        num_examples = int(window_example_ids.max()) + 1
    per_doc_labels: List[List[int]] = [[] for _ in range(num_examples)]
    per_doc_scores: List[List[np.ndarray]] = [[] for _ in range(num_examples)]
    for wi in range(window_sent_labels.shape[0]):
        eid = int(window_example_ids[wi])
        live = window_sent_labels[wi] != IGNORE
        per_doc_labels[eid].extend(window_sent_labels[wi][live].tolist())
        per_doc_scores[eid].append(gathered_scores[wi][live])
    out = []
    for eid in range(num_examples):
        scores = (
            np.concatenate(per_doc_scores[eid], axis=0)
            if per_doc_scores[eid]
            else np.zeros((0, gathered_scores.shape[-1]), dtype=gathered_scores.dtype)
        )
        out.append(
            {
                "labels": np.asarray(per_doc_labels[eid], dtype=np.int32),
                "scores": scores,
            }
        )
    return out
