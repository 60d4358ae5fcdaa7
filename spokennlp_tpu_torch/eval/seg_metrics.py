"""Segmentation metrics: boundary P/R/F1, Pk, WinDiff, example-level eval.

The port's own copy of ``spokennlp_tpu/eval/seg_metrics.py`` (same behaviour; imports
only the port, numpy and the standard library).

Self-contained reimplementation of the metric surface the reference obtains
from seqeval + segeval + sklearn (reference: emnlp2023-topic_segmentation/
src/metrics/seqeval.py:108-373):

- :func:`boundary_prf` — entity-level P/R/F1 for the positive (B-EOP) class;
  with length-1 "B-EOP" entities seqeval's micro-averaged scores reduce to
  plain binary P/R/F1 on the boundary class.
- :func:`pk_metric` / :func:`windowdiff_metric` — Beeferman Pk and Pevzner &
  Hearst WindowDiff over segment-mass sequences, window size
  ``k = round(mean(reference masses) / 2)`` (segeval's convention).
- :func:`mass_from_boundary_labels` — [1,1,0,0,1,1] -> [1,1,3,1] conversion
  (reference: seqeval.py:178-192).
- :func:`compute_window_metric` — corpus-level 1-Pk / 1-WD / P/R/F1 summary
  (reference: seqeval.py:173-237).
- :func:`compute_example_level_metric` — threshold / top-k / top-k+threshold /
  soft-F1@k re-assignment modes (reference: seqeval.py:248-373).

Convention: in label space, label 0 ("B-EOP") marks the END sentence of a
topic; in binary space 1 means boundary. ``binary = 1 - label`` for the 2-label
scheme.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

IGNORE = -100
LABEL_EOP = 0  # "B-EOP"
LABEL_O = 1  # "O"


# ---------------------------------------------------------------------------
# boundary P/R/F1 (seqeval-equivalent for the B-EOP/O scheme)
# ---------------------------------------------------------------------------


def boundary_prf(
    predictions: Sequence[Sequence[int]],
    references: Sequence[Sequence[int]],
    positive_label: int = LABEL_EOP,
) -> Dict[str, float]:
    """Micro P/R/F1 of the positive class plus token accuracy.

    Inputs are per-example label-id sequences (0 = B-EOP, 1 = O), already
    stripped of ignored positions.
    """
    tp = fp = fn = correct = total = 0
    for pred, ref in zip(predictions, references):
        p = np.asarray(pred)
        r = np.asarray(ref)
        assert p.shape == r.shape, "prediction/reference length mismatch"
        total += p.size
        correct += int(np.count_nonzero(p == r))
        pp = p == positive_label
        rr = r == positive_label
        tp += int(np.count_nonzero(pp & rr))
        fp += int(np.count_nonzero(pp & ~rr))
        fn += int(np.count_nonzero(~pp & rr))
    precision = tp / (tp + fp) if tp + fp else 0.0
    recall = tp / (tp + fn) if tp + fn else 0.0
    f1 = 2 * precision * recall / (precision + recall) if precision + recall else 0.0
    accuracy = correct / total if total else 0.0
    return {
        "overall_precision": precision,
        "overall_recall": recall,
        "overall_f1": f1,
        "overall_accuracy": accuracy,
        "support": tp + fn,
    }


def binary_prf(
    predictions: Sequence[int], references: Sequence[int]
) -> Dict[str, float]:
    """Binary P/R/F1 where 1 is the positive class (flat sequences)."""
    pred = np.asarray(predictions)
    ref = np.asarray(references)
    tp = int(np.sum((pred == 1) & (ref == 1)))
    fp = int(np.sum((pred == 1) & (ref == 0)))
    fn = int(np.sum((pred == 0) & (ref == 1)))
    precision = tp / (tp + fp) if tp + fp else 0.0
    recall = tp / (tp + fn) if tp + fn else 0.0
    f1 = 2 * precision * recall / (precision + recall) if precision + recall else 0.0
    micro_f1 = float(np.mean(pred == ref)) if len(pred) else 0.0
    return {"precision": precision, "recall": recall, "f1": f1, "micro_f1": micro_f1}


# ---------------------------------------------------------------------------
# mass conversion + Pk / WindowDiff
# ---------------------------------------------------------------------------


def mass_from_boundary_labels(labels: Sequence[int]) -> List[int]:
    """Convert an end-of-segment indicator sequence into segment masses.

    ``labels[i] == 1`` means sentence i ENDS its segment.
    [1, 1, 0, 0, 1, 1] -> [1, 1, 3, 1]; a trailing open segment is closed.
    """
    arr = np.asarray(labels)
    n = arr.shape[0]
    ends = np.flatnonzero(arr == 1)
    closed = np.diff(ends + 1, prepend=0)
    mass = closed.tolist()
    tail = n - (int(ends[-1]) + 1 if len(ends) else 0)
    if tail > 0:
        mass.append(tail)
    return mass


def _boundary_string(mass: Sequence[int]) -> np.ndarray:
    """Positions of internal boundaries: b[i] = 1 iff a boundary follows unit i.

    Length is total units - 1 (no trailing boundary).
    """
    n = int(sum(mass))
    b = np.zeros(max(n - 1, 0), dtype=np.int32)
    if len(mass) > 1:
        b[np.cumsum(np.asarray(mass[:-1], dtype=np.int64)) - 1] = 1
    return b


def _window_size(reference_mass: Sequence[int]) -> int:
    """segeval convention: half the mean reference segment length, rounded."""
    k = int(round(sum(reference_mass) / len(reference_mass) / 2.0))
    return max(k, 1)


def pk_metric(
    hypothesis_mass: Sequence[int],
    reference_mass: Sequence[int],
    k: Optional[int] = None,
) -> float:
    """Beeferman's Pk: probability that two units k apart are misclassified
    as same/different segment. Lower is better."""
    assert sum(hypothesis_mass) == sum(reference_mass), "total mass mismatch"
    n = int(sum(reference_mass))
    if k is None:
        k = _window_size(reference_mass)
    if n <= k:
        return 0.0
    ref_seg = _unit_segment_ids(reference_mass)
    hyp_seg = _unit_segment_ids(hypothesis_mass)
    same_ref = ref_seg[: n - k] == ref_seg[k:n]
    same_hyp = hyp_seg[: n - k] == hyp_seg[k:n]
    count = n - k
    errors = int(np.count_nonzero(same_ref != same_hyp))
    return errors / count if count else 0.0


def windowdiff_metric(
    hypothesis_mass: Sequence[int],
    reference_mass: Sequence[int],
    k: Optional[int] = None,
) -> float:
    """Pevzner & Hearst WindowDiff. Lower is better."""
    assert sum(hypothesis_mass) == sum(reference_mass), "total mass mismatch"
    n = int(sum(reference_mass))
    if k is None:
        k = _window_size(reference_mass)
    if n <= k:
        return 0.0
    ref_b = _boundary_string(reference_mass)
    hyp_b = _boundary_string(hypothesis_mass)
    ref_cum = np.concatenate([[0], np.cumsum(ref_b)])
    hyp_cum = np.concatenate([[0], np.cumsum(hyp_b)])
    rb = ref_cum[k : n] - ref_cum[: n - k]
    hb = hyp_cum[k : n] - hyp_cum[: n - k]
    count = n - k
    errors = int(np.count_nonzero(rb != hb))
    return errors / count if count else 0.0


def _unit_segment_ids(mass: Sequence[int]) -> np.ndarray:
    return np.repeat(
        np.arange(len(mass), dtype=np.int32), np.asarray(mass, np.int64)
    )


# ---------------------------------------------------------------------------
# corpus-level window metric (reference: seqeval.py:173-237)
# ---------------------------------------------------------------------------


def compute_window_metric(
    predictions: Sequence[Sequence[int]],
    references: Sequence[Sequence[int]],
    prefix: str = "",
) -> Dict[str, float]:
    """1-Pk / 1-WD averaged over examples + corpus-flat binary P/R/F1.

    Inputs are per-example BINARY sequences: 1 = end sentence of topic.
    Examples where the metric is undefined (e.g. length mismatch) are skipped,
    matching the reference's try/except behavior.
    """
    one_minus_pk, one_minus_wd = [], []
    for pred, ref in zip(predictions, references):
        try:
            pred_mass = mass_from_boundary_labels(pred)
            ref_mass = mass_from_boundary_labels(ref)
            assert sum(pred_mass) == sum(ref_mass)
            pk = pk_metric(pred_mass, ref_mass)
            wd = windowdiff_metric(pred_mass, ref_mass)
            one_minus_pk.append(1 - pk)
            one_minus_wd.append(1 - wd)
        except Exception:
            continue
    total_pk = round(float(np.mean(one_minus_pk)), 4) if one_minus_pk else 0.0
    total_wd = round(float(np.mean(one_minus_wd)), 4) if one_minus_wd else 0.0

    flat_pred = (
        np.concatenate([np.asarray(p) for p in predictions])
        if predictions else np.zeros(0, np.int64)
    )
    flat_ref = (
        np.concatenate([np.asarray(r) for r in references])
        if references else np.zeros(0, np.int64)
    )
    prf = binary_prf(flat_pred, flat_ref)
    n = len(predictions)
    return {
        prefix + "1-pk": total_pk,
        prefix + "1-wd": total_wd,
        prefix + "precision": round(prf["precision"], 4),
        prefix + "recall": round(prf["recall"], 4),
        prefix + "f1": round(prf["f1"], 4),
        prefix + "pk": round(1 - total_pk, 4),
        prefix + "wd": round(1 - total_wd, 4),
        prefix + "avg_pred_cnt": round(float(np.sum(flat_pred)) / n, 2) if n else 0.0,
        prefix + "avg_true_cnt": round(float(np.sum(flat_ref)) / n, 2) if n else 0.0,
    }


# ---------------------------------------------------------------------------
# example-level evaluation (reference: seqeval.py:248-373)
# ---------------------------------------------------------------------------


def softmax(x: np.ndarray, axis: int = -1) -> np.ndarray:
    x = x - x.max(axis=axis, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=axis, keepdims=True)


def compute_example_level_metric(
    predictions_logits: Sequence[np.ndarray],
    labels: Sequence[Sequence[int]],
    threshold: Optional[float] = None,
    topk: Optional[int] = None,
    topk_with_threshold: bool = False,
    f1_at_k: Optional[int] = None,
    ts_score_predictor: str = "lt",
) -> Dict[str, float]:
    """Document-level segmentation eval with decision-rule variants.

    Args:
      predictions_logits: per document, (S, 2) logits ("lt") or (S,)
        sigmoid-of-cosine similarities ("cos").
      labels: per document, label ids (0 = B-EOP end of topic, 1 = O).
      threshold: if set, predict boundary where P(B-EOP) >= threshold.
      topk: if set, predict the k highest-scoring sentences as boundaries.
      topk_with_threshold: intersect top-k with the threshold rule.
      f1_at_k: tolerance window — a predicted boundary within k sentences of
        an unmatched true boundary is snapped onto it.
    """
    results: Dict[str, float] = {}
    if ts_score_predictor == "lt":
        argmax_preds = [np.argmax(np.asarray(lg), axis=-1) for lg in predictions_logits]
        seg_scores = [softmax(np.asarray(lg), axis=-1)[:, LABEL_EOP] for lg in predictions_logits]
    else:
        argmax_preds = [
            np.where(np.asarray(lg) > 0.5, LABEL_O, LABEL_EOP)
            for lg in predictions_logits
        ]
        seg_scores = [1.0 - np.asarray(lg, dtype=np.float64) for lg in predictions_logits]

    prf = boundary_prf(argmax_preds, labels)
    results.update(
        {
            "precision": prf["overall_precision"],
            "recall": prf["overall_recall"],
            "f1": prf["overall_f1"],
            "accuracy": prf["overall_accuracy"],
        }
    )

    # binary space: 1 = boundary
    ref_binary = [
        (np.asarray(ref) == LABEL_EOP).astype(np.int64) for ref in labels
    ]

    if threshold is not None:
        pred_binary = [
            (scores >= threshold).astype(np.int64) for scores in seg_scores
        ]
        results.update(
            compute_window_metric(
                pred_binary, ref_binary, prefix=f"threshold_{threshold}_example_level_"
            )
        )

    if topk is not None:
        prefix = f"topk_{topk}_example_level_"
        keep = [np.argsort(-scores, kind="stable")[:topk] for scores in seg_scores]
        pred_binary = []
        for scores, idx in zip(seg_scores, keep):
            p = np.zeros(len(scores), dtype=np.int64)
            if len(idx):
                p[idx] = 1
            pred_binary.append(p.tolist())
        results.update(compute_window_metric(pred_binary, ref_binary, prefix=prefix))

        if topk_with_threshold:
            assert threshold is not None
            pred_binary = []
            for scores, idx in zip(seg_scores, keep):
                p = np.zeros(len(scores), dtype=np.int64)
                sel = [i for i in idx if scores[i] >= threshold]
                if sel:
                    p[np.asarray(sel)] = 1
                pred_binary.append(p.tolist())
            results.update(
                compute_window_metric(
                    pred_binary,
                    ref_binary,
                    prefix=f"topk_{topk}_with_threshold_{threshold}_example_level_",
                )
            )

    if f1_at_k:
        assert threshold is not None
        soft_preds = []
        for scores, ref in zip(seg_scores, ref_binary):
            pred = (scores >= threshold).astype(np.int64).tolist()
            for i, p in enumerate(pred):
                if p == 0 or (p == 1 and ref[i] == 1):
                    continue
                left = max(0, i - f1_at_k)
                right = min(len(pred) - 1, i + f1_at_k)
                for j in range(left, right + 1):
                    if ref[j] == 1:
                        pred[i] = 0
                        pred[j] = 1
                        break
            soft_preds.append(pred)
        results.update(
            compute_window_metric(
                soft_preds, ref_binary, prefix=f"f1@{f1_at_k}_example_level_"
            )
        )
    return results
