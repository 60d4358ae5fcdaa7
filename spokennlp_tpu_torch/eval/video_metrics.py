"""Time-aware video topic-segmentation metrics (MMVTS eval suite).

The port's own copy of ``spokennlp_tpu/eval/video_metrics.py`` (same
behaviour; imports only the port, numpy and the standard library), which
reimplements mmvts/src/evaluate.py's metric kernel functions:
- :func:`bs_at_k`        — boundary score @ +/- k seconds (:171-193)
- :func:`f1_tolerance`   — hit/label/pred counts for tolerant F1 (:195-215)
- :func:`miou_by_overlap`— symmetric mean IoU of topic intervals (:217-268)
- :func:`clip_f1`        — clip-level boundary P/R/F1
plus per-example aggregation, the per-type breakdown, the LLM-prediction
scorer and multi-run avg±std summaries.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from spokennlp_tpu_torch.eval.seg_metrics import binary_prf, compute_window_metric


def _claim_closest(label_seconds: List[float], pred: float, th: float) -> int:
    """First label within ``th`` of pred (reference closest_number1)."""
    for i, val in enumerate(label_seconds):
        if abs(val - pred) < th:
            return i
    return -1


def bs_at_k(
    label_end_seconds: Sequence[float],
    pred_end_seconds: Sequence[float],
    threshold: float = 30.0,
) -> Tuple[float, int, int]:
    """Boundary score: fraction of true boundaries claimed by a prediction
    within ``threshold`` seconds; each label claimable once (:171-193).

    Returns (bs_score, hits_excluding_final, labels_excluding_final).
    """
    assert len(label_end_seconds) >= 1
    pool = list(label_end_seconds)
    cnt = 0
    for p in pred_end_seconds:
        idx = _claim_closest(pool, p, threshold)
        if idx == -1:
            continue
        pool[idx] = -1e9
        cnt += 1
    return cnt / len(label_end_seconds), cnt - 1, len(label_end_seconds) - 1


def f1_tolerance(
    label_end_seconds: Sequence[float],
    pred_end_seconds: Sequence[float],
    threshold: float = 30.0,
) -> Tuple[int, int, int]:
    """(hits, n_labels, n_preds), each excluding the trivial final boundary
    (:195-215)."""
    _, hits, n_labels = bs_at_k(label_end_seconds, pred_end_seconds, threshold)
    return hits, n_labels, len(pred_end_seconds) - 1


def _ends_to_intervals(end_seconds: Sequence[float]) -> List[Tuple[float, float]]:
    out = []
    prev = 0.0
    for e in end_seconds:
        out.append((prev, e))
        prev = e
    return out


def miou_by_overlap(
    label_end_seconds: Sequence[float], pred_end_seconds: Sequence[float]
) -> float:
    """Symmetric mean best-IoU between topic intervals (:217-268)."""

    def iou(a, b):
        inter = max(0.0, min(a[1], b[1]) - max(a[0], b[0]))
        if inter == 0:
            return 0.0
        union = max(a[1], b[1]) - min(a[0], b[0])
        return inter / union

    gt = _ends_to_intervals(label_end_seconds)
    pr = _ends_to_intervals(pred_end_seconds)
    m1 = np.mean([max(iou(p, g) for p in pr) for g in gt])
    m2 = np.mean([max(iou(g, p) for g in gt) for p in pr])
    return float(np.mean([m1, m2]))


def clip_f1(
    label_seqs: Sequence[Sequence[int]], pred_seqs: Sequence[Sequence[int]]
) -> Dict[str, float]:
    """Clip-level boundary P/R/F1 over the corpus (1 = end of topic)."""
    flat_l = [v for seq in label_seqs for v in seq]
    flat_p = [v for seq in pred_seqs for v in seq]
    return binary_prf(flat_p, flat_l)


def evaluate_video_corpus(
    examples: Sequence[Dict],
    bs_threshold: float = 30.0,
) -> Dict[str, float]:
    """Full eval over a corpus of per-video predictions.

    Each example: {"labels": [0/1 per clip, 1=end], "preds": [0/1 per clip],
    "clip_end_seconds": [t per clip]} — the final clip counts as a boundary
    in the time-aware metrics (reference appends the video end, :149-152).
    """
    bs_scores, mious = [], []
    total_hits = total_labels = total_preds = 0
    for ex in examples:
        secs = ex["clip_end_seconds"]
        # explicit ground-truth boundary seconds override the clip-derived
        # ones (the reference's LLM path scores against topic_end_seconds,
        # evaluate.py:93-99)
        label_ends = ex.get("label_end_seconds") or [
            s for s, l in zip(secs, ex["labels"]) if l == 1
        ]
        pred_ends = [s for s, p in zip(secs, ex["preds"]) if p == 1]
        if not label_ends or label_ends[-1] != secs[-1]:
            label_ends = label_ends + [secs[-1]]
        if not pred_ends or pred_ends[-1] != secs[-1]:
            pred_ends = pred_ends + [secs[-1]]
        bs, hits, n_labels = bs_at_k(label_ends, pred_ends, bs_threshold)
        bs_scores.append(bs)
        mious.append(miou_by_overlap(label_ends, pred_ends))
        h, nl, npred = f1_tolerance(label_ends, pred_ends, bs_threshold)
        total_hits += max(h, 0)
        total_labels += max(nl, 0)
        total_preds += max(npred, 0)

    cf = clip_f1([e["labels"] for e in examples], [e["preds"] for e in examples])
    win = compute_window_metric(
        [e["preds"] for e in examples], [e["labels"] for e in examples]
    )
    p_tol = total_hits / total_preds if total_preds else 0.0
    r_tol = total_hits / total_labels if total_labels else 0.0
    f_tol = 2 * p_tol * r_tol / (p_tol + r_tol) if p_tol + r_tol else 0.0
    return {
        f"bs@{int(bs_threshold)}": float(np.mean(bs_scores)),
        "miou": float(np.mean(mious)),
        "clip_precision": cf["precision"],
        "clip_recall": cf["recall"],
        "clip_f1": cf["f1"],
        "1-pk": win["1-pk"],
        "1-wd": win["1-wd"],
        f"f1_tolerance@{int(bs_threshold)}": f_tol,
    }


def summarize_runs(run_metrics: Sequence[Dict[str, float]]) -> Dict[str, str]:
    """avg±std over repeated experiments (reference multi-exp aggregation)."""
    keys = run_metrics[0].keys()
    return {
        k: f"{np.mean([m[k] for m in run_metrics]):.4f}±{np.std([m[k] for m in run_metrics]):.4f}"
        for k in keys
    }


def evaluate_video_corpus_by_type(
    examples: Sequence[Dict],
    type_of: Dict[str, str],
    bs_threshold: float = 30.0,
) -> Dict[str, Dict[str, float]]:
    """Per-video-type metric breakdown (reference: mmvts/src/evaluate.py:
    534-613 evaluate_by_type, which groups courses by en/cn type tables).

    ``type_of`` maps example/video ids to type names; examples carry an
    "example_id". Returns {"__all__": overall, <type>: metrics}.
    """
    out = {"__all__": evaluate_video_corpus(examples, bs_threshold)}
    by_type: Dict[str, list] = {}
    for ex in examples:
        t = type_of.get(str(ex.get("example_id", "")), None)
        if t is not None:
            by_type.setdefault(t, []).append(ex)
    for t, exs in sorted(by_type.items()):
        out[t] = evaluate_video_corpus(exs, bs_threshold)
    return out


def llm_predictions_to_examples(
    data_rows: Sequence[Dict], pred_rows: Sequence[Dict],
    prediction_key: str = "predict",
) -> List[Dict]:
    """Score LLM-generated 0/1 boundary predictions (reference:
    evaluate.py:84-109 get_llm_result + :706-725 evaluate_llm): truncate the
    LLM output to the label length (LLMs over/under-generate), force the
    final clip to close a topic on BOTH sides, take prediction boundary
    seconds from the clip end times ("stet") and ground-truth seconds from
    topic_end_seconds."""
    examples = []
    for d, p in zip(data_rows, pred_rows):
        labels = list(d["labels"])[:-1]
        raw = list(p[prediction_key])[: len(labels)]
        preds = [1 if v in (1, "1") else 0 for v in raw]
        preds += [0] * (len(labels) - len(preds))
        labels.append(1)
        preds.append(1)
        secs = [float(st[1]) for st in d["stet"]][: len(labels)]
        while len(secs) < len(labels):
            secs.append(secs[-1] if secs else 0.0)
        examples.append({
            "example_id": d.get("example_id", ""),
            "labels": labels,
            "preds": preds,
            "clip_end_seconds": secs,
            "label_end_seconds": [float(v) for v in d["topic_end_seconds"]],
        })
    return examples


def evaluate_llm_corpus(
    data_rows: Sequence[Dict], pred_rows: Sequence[Dict],
    bs_threshold: float = 30.0, prediction_key: str = "predict",
) -> Dict[str, float]:
    """Full LLM-prediction scoring (evaluate_llm, evaluate.py:706-725)."""
    return evaluate_video_corpus(
        llm_predictions_to_examples(data_rows, pred_rows, prediction_key),
        bs_threshold,
    )
