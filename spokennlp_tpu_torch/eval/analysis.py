"""Analysis suite: score ensembling, sentence-level re-mapping, run
statistics, result formatting and plots.

The port's own copy of ``spokennlp_tpu/eval/analysis.py`` (the reference's
analysis scripts: emnlp2023-topic_segmentation/src/analysis/
ensemble_scores.py:49, src/postprocess_predictions.py:29-89,
src/analysis/statistics_of_result.py:5-38, src/utils.py:7-48,
src/analysis/plot_figure.py). ``compute_p_value`` uses scipy where it
imports; ``plot_metric_curves`` needs matplotlib and raises, naming it,
where it is missing.
"""

from __future__ import annotations

import json
import math
import os
from typing import Dict, Sequence

import numpy as np

from spokennlp_tpu_torch.eval.seg_metrics import compute_window_metric, softmax


def stable_sigmoid(x: float) -> float:
    if x >= 0:
        return 1.0 / (1.0 + math.exp(-x))
    e = math.exp(x)
    return e / (1.0 + e)


def ensemble_scores(
    per_doc_logits: Sequence[np.ndarray],
    per_doc_cos_sims: Sequence[Sequence[float]],
    per_doc_labels: Sequence[Sequence[int]],
    sim_temp: float = 1.0,
    threshold: float = 0.5,
) -> Dict[str, float]:
    """Mean of softmax seg-prob and sigmoid(-cos_sim) (ensemble_scores.py:49):
    pred = 1 if (P(B-EOP) + sigmoid(-cos)) / 2 > threshold."""
    preds, refs = [], []
    for logits, sims, labels in zip(per_doc_logits, per_doc_cos_sims, per_doc_labels):
        probs = softmax(np.asarray(logits), axis=-1)[:, 0]
        doc_preds = [
            1 if (p + stable_sigmoid(-s * sim_temp)) / 2 > threshold else 0
            for p, s in zip(probs, sims)
        ]
        preds.append(doc_preds)
        refs.append([1 if l == 0 else 0 for l in labels])  # binary: 1 = seg
    return compute_window_metric(preds, refs, prefix="ensemble_")


def sent_level_metric_from_para_level(
    para_level_predictions: Sequence[Sequence[int]],
    para_level_labels: Sequence[Sequence[int]],
    sent_level_labels: Sequence[Sequence[int]],
) -> Dict[str, Dict[str, float]]:
    """Map paragraph-level predictions onto the sentence grid and score both
    levels (postprocess_predictions.py:50-75). ``sent_level_labels`` use the
    raw corpus space (1 topic end, 0 paragraph end, -100 other), excluding
    each document's final sentence."""
    sent_preds, sent_refs = [], []
    for para_pred, para_lab, sent_lab in zip(
        para_level_predictions, para_level_labels, sent_level_labels
    ):
        assert len(para_lab) == len([v for v in sent_lab if v != -100])
        preds = [0] * len(sent_lab)
        refs = []
        p_id = 0
        for i, v in enumerate(sent_lab):
            if v != -100:
                preds[i] = para_pred[p_id]
                refs.append(v if v in (0, 1) else 0)
                p_id += 1
            else:
                refs.append(0)
        sent_preds.append(preds)
        sent_refs.append(refs)
    return {
        "sent_level": compute_window_metric(sent_preds, sent_refs),
        "para_level": compute_window_metric(
            [list(p) for p in para_level_predictions],
            [list(l) for l in para_level_labels],
        ),
    }


def compute_avg_std(runs: Sequence[Sequence[float]], metrics: Sequence[str]):
    """Multi-seed mean/std table (statistics_of_result.py:5-27)."""
    out = {}
    arr = np.asarray(runs, dtype=np.float64)  # (n_runs, n_metrics)
    for i, m in enumerate(metrics):
        vals = arr[:, i]
        out[m] = {
            "mean": float(vals.mean()),
            "std": float(vals.std(ddof=1)) if len(vals) > 1 else 0.0,
        }
    return out


def compute_p_value(x: Sequence[float], y: Sequence[float]) -> float:
    """Two-sample t-test p-value (statistics_of_result.py:30-38)."""
    try:
        from scipy.stats import ttest_ind
    except ImportError:
        # pooled t statistic, normal approximation
        x, y = np.asarray(x, float), np.asarray(y, float)
        nx, ny = len(x), len(y)
        sp = np.sqrt(((nx - 1) * x.var(ddof=1) + (ny - 1) * y.var(ddof=1)) / (nx + ny - 2))
        t = (x.mean() - y.mean()) / (sp * np.sqrt(1 / nx + 1 / ny))
        return float(2 * (1 - 0.5 * (1 + math.erf(abs(t) / math.sqrt(2)))))
    return float(ttest_ind(list(x), list(y)).pvalue)


def data_statistics(examples: Sequence[Dict]) -> Dict[str, float]:
    """Corpus stats (statistics_of_data.py:16): docs/topics/sentences."""
    n_docs = len(examples)
    n_sents = sum(len(ex["sentences"]) for ex in examples)
    n_topics = sum(
        sum(1 for l in ex["labels"] if l in (1, "1", 0)) for ex in examples
    )
    n_boundaries = sum(
        sum(1 for l in ex["labels"] if l in (1, "1")) for ex in examples
    )
    return {
        "documents": n_docs,
        "sentences": n_sents,
        "labeled_positions": n_topics,
        "topic_boundaries": n_boundaries,
        "avg_sentences_per_doc": n_sents / max(n_docs, 1),
    }


def abridge_model_name(model_name_or_path: str) -> str:
    """Short model tag for result-file naming (reference:
    emnlp2023-topic_segmentation/src/utils.py:7-20)."""
    name = model_name_or_path.lower()
    if "longformer" in name:
        return "lf"
    if "bigbird" in name:
        return "bb"
    if "electra" in name:
        return "ele"
    if "bert" in name:
        return "bert"
    raise ValueError(f"not supported model_name: {model_name_or_path}")


def convert_res_format(file_path: str, threshold) -> str:
    """Results json -> 'p / r / f / pk / wd' one-liner next to the file
    (reference: src/utils.py:22-48). Returns the formatted string."""
    with open(file_path) as f:
        res = json.load(f)
    prefix = f"threshold_{threshold}_example_level"
    vals = [
        res[f"{prefix}_{k}"] for k in ("precision", "recall", "f1", "pk", "wd")
    ]
    line = (
        f"{prefix}_metric\n"
        + " / ".join(f"{float(v) * 100:.2f}" for v in vals)
    )
    out_path = os.path.join(
        os.path.dirname(file_path),
        os.path.basename(file_path).split(".json")[0] + "_str_metric.txt",
    )
    with open(out_path, "w") as f:
        f.write("p / r / f / pk / wd\n" + line + "\n\n")
    return line


def plot_metric_curves(
    x_values,
    series,
    out_path: str,
    xlabel: str = "context length",
    ylabel: str = "F1",
    annotate: bool = True,
):
    """Line plot of metric curves across a sweep (reference:
    emnlp2023-topic_segmentation/src/analysis/plot_figure.py — F1 vs context
    length, dashed baselines vs solid ours, point annotations).

    ``series``: {label: (values, style_dict)} or {label: values}. Headless
    backend; writes a file and returns the path.
    """
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("plot_metric_curves needs matplotlib, which is not installed") from e

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6, 4))
    for label, spec in series.items():
        if isinstance(spec, tuple):
            values, style = spec
        else:
            values, style = spec, {}
        ax.plot(x_values, values, marker=style.get("marker", "o"),
                linestyle=style.get("linestyle", "-"),
                color=style.get("color"), label=label)
        if annotate:
            for xv, yv in zip(x_values, values):
                ax.text(xv, yv, f"{yv}")
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    ax.legend()
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
    return out_path
