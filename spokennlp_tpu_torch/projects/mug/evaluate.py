"""Official MUG challenge offline scorer, all 5 tracks.

The port's own copy of ``spokennlp_tpu/projects/mug/evaluate.py`` (same behaviour; imports
only the port, numpy and the standard library).

Reimplements alimeeting4mug/src/utils/challenge_evaluate.py:38-581 with local
label files instead of the ModelScope hub download (zero-egress environment).
Rank-score formulas match the reference exactly:

  Track1 topic seg:   0.5 * pos_F1 + 0.25 * ((1-Pk) + (1-WD))        (:138-140)
  Track2 extractive:  mean of 12 multi-ref avg/max rouge-1/2/l F     (:264-267)
  Track3 titles:      mean of 6  multi-ref avg/max rouge-1/2/l F     (:343-346)
  Track4 keyphrase:   mean of partial-F1 (fuzzy LCS>=2) + exact-F1
                      (rouge-1 F) at @10/@15/@20                      (:401-417)
  Track5 action item: positive-class F1                               (:520-545)
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from spokennlp_tpu_torch.eval import seg_metrics
from spokennlp_tpu_torch.eval.rouge import multi_reference_rouge, rouge_scores
from spokennlp_tpu_torch.projects.mug.data import read_jsonl
from spokennlp_tpu_torch.utils.tokenization import BasicTokenizer

_tokenizer = BasicTokenizer(do_lower_case=True)


def _tok(text: str) -> str:
    return " ".join(_tokenizer.tokenize(text))


def topic_segment_evaluate(label_samples: List[Dict], pred_samples: List[Dict]) -> Dict:
    assert len(label_samples) == len(pred_samples), "NUMBER ERROR."
    total_preds, total_labels = [], []
    preds_split, labels_split = [], []
    for l_sample, p_sample in zip(label_samples, pred_samples):
        assert l_sample["meeting_key"] == p_sample["meeting_key"], "meeting_key error."
        n = len(l_sample["sentences"])
        para_ids = {p["id"] for p in l_sample.get("paragraph_segment_ids", [])}
        labels = [0] * n
        preds = [0] * n
        for t in l_sample.get("topic_segment_ids", []):
            labels[t["id"] - 1] = 1
        for t in p_sample.get("topic_segment_ids", []):
            preds[t["id"] - 1] = 1
        preds[-1] = 1
        labels[-1] = 1
        # only paragraph-end sentences are scored (:194-198)
        labels = [v for i, v in enumerate(labels) if (i + 1) in para_ids]
        preds = [v for i, v in enumerate(preds) if (i + 1) in para_ids]
        total_labels.extend(labels[:-1])
        total_preds.extend(preds[:-1])
        labels_split.append(labels[:-1])
        preds_split.append(preds[:-1])

    prf = seg_metrics.binary_prf(total_preds, total_labels)
    window = seg_metrics.compute_window_metric(
        preds_split, labels_split, prefix="test_"
    )
    score = 0.5 * prf["f1"] + 0.25 * (window["test_1-pk"] + window["test_1-wd"])
    out = {"score": score}
    out.update(
        {
            k: v
            for k, v in window.items()
            if not k.endswith("avg_pred_cnt") and not k.endswith("avg_true_cnt")
        }
    )
    out["test_pos_f1"] = prf["f1"]
    return out


def _es_text(sentences: Sequence[str], key_ids) -> str:
    return "".join(sentences[int(i) - 1] for i in key_ids)


def extractive_summarization_evaluate(
    label_samples: List[Dict], pred_samples: List[Dict]
) -> Dict:
    assert len(label_samples) == len(pred_samples)
    topic_refs, topic_preds, doc_refs, doc_preds = [], [], [], []
    for l_sample, p_sample in zip(label_samples, pred_samples):
        assert l_sample["meeting_key"] == p_sample["meeting_key"]
        sentences = [s["s"] for s in l_sample["sentences"]]
        l_topics = l_sample["topic_segment_ids"]
        p_topics = p_sample["topic_segment_ids"]
        assert len(l_topics) == len(p_topics)
        for lt, pt in zip(l_topics, p_topics):
            topic_refs.append(
                [_tok(_es_text(sentences, ref["key_sentence"])) for ref in lt["candidate"]]
            )
            topic_preds.append(_tok(_es_text(sentences, pt["key_sentence"])))
        doc_refs.append(
            [_tok(_es_text(sentences, ref["key_sentence"])) for ref in l_sample["candidate"]]
        )
        doc_preds.append(_tok(_es_text(sentences, p_sample["key_sentence"])))

    topic_res = multi_reference_rouge(topic_preds, topic_refs)
    doc_res = multi_reference_rouge(doc_preds, doc_refs)
    score_items = [
        res[f"multi-ref-{s_type}_rouge-{s_val}_f"]
        for res in (topic_res, doc_res)
        for s_type in ("average", "max")
        for s_val in ("1", "2", "l")
    ]
    out = {"score": float(np.mean(score_items))}
    for name, res in (("topic-es_", topic_res), ("doc-es_", doc_res)):
        for k, v in res.items():
            out[k.replace("multi-ref-", name)] = v
    return out


def topic_title_generation_evaluate(
    label_samples: List[Dict], pred_samples: List[Dict]
) -> Dict:
    assert len(label_samples) == len(pred_samples)
    refs, preds = [], []
    for l_sample, p_sample in zip(label_samples, pred_samples):
        assert l_sample["meeting_key"] == p_sample["meeting_key"]
        l_topics = l_sample["topic_segment_ids"]
        p_topics = p_sample["topic_segment_ids"]
        assert len(l_topics) == len(p_topics)
        for lt, pt in zip(l_topics, p_topics):
            refs.append([_tok(ref["title"]) for ref in lt["candidate"]])
            preds.append(_tok(pt["title"]))
    res = multi_reference_rouge(preds, refs)
    score_items = [
        res[f"multi-ref-{s_type}_rouge-{s_val}_f"]
        for s_type in ("average", "max")
        for s_val in ("1", "2", "l")
    ]
    out = {"score": float(np.mean(score_items))}
    for k, v in res.items():
        out[k.replace("multi-ref-", "ttg_")] = v
    return out


# ---------------------------------------------------------------- keyphrase


def is_fuzzy_match(a: str, b: str) -> bool:
    """Longest common substring >= 2 (challenge_evaluate.py:432-455)."""
    a, b = a.strip(), b.strip()
    if not a or not b:
        return False
    best = 0
    prev = [0] * (len(b) + 1)
    for i in range(1, len(a) + 1):
        cur = [0] * (len(b) + 1)
        for j in range(1, len(b) + 1):
            if a[i - 1] == b[j - 1]:
                cur[j] = prev[j - 1] + 1
                best = max(best, cur[j])
        prev = cur
    return best >= 2


def example_partial_f1(keywords: Sequence[str], goldenwords: Sequence[str]) -> float:
    if not keywords or not goldenwords:
        return 0.0
    p_num = sum(1 for k in keywords if any(is_fuzzy_match(k, g) for g in goldenwords))
    r_num = sum(1 for g in goldenwords if any(is_fuzzy_match(k, g) for k in keywords))
    p = p_num / len(keywords)
    r = r_num / len(goldenwords)
    return 2 * p * r / (p + r) if p + r else 0.0


def kpe_compute(
    predictions: Sequence[Sequence[str]], references: Sequence[Sequence[str]]
) -> Dict:
    scores = {}
    total = 0.0
    for num in (10, 15, 20):
        preds_at = [list(p)[:num] for p in predictions]
        partial = float(
            np.mean([example_partial_f1(p, r) for p, r in zip(preds_at, references)])
        )
        exact = rouge_scores(
            [" ".join(p) for p in preds_at], [" ".join(r) for r in references]
        )["rouge-1"]["f"]
        scores[f"partial_f1@{num}"] = partial
        scores[f"exact_f1@{num}"] = exact
        total += partial + exact
    out = {"score": total / len(scores)}
    out.update(scores)
    return out


def keyphrase_extraction_evaluate(
    label_samples: List[Dict], pred_samples: List[Dict]
) -> Dict:
    assert len(label_samples) == len(pred_samples)
    preds, refs = [], []
    for l_sample, p_sample in zip(label_samples, pred_samples):
        assert l_sample["meeting_key"] == p_sample["meeting_key"]
        kws = [c["key_word"] for c in l_sample["candidate"]]
        refs.append([w for ww in kws for w in ww])
        preds.append(p_sample["key_word"])
    return kpe_compute(predictions=preds, references=refs)


def action_item_detection_evaluate(
    label_samples: List[Dict], pred_samples: List[Dict]
) -> Dict:
    assert len(label_samples) == len(pred_samples)
    total_preds, total_labels = [], []
    for l_sample, p_sample in zip(label_samples, pred_samples):
        assert l_sample["meeting_key"] == p_sample["meeting_key"]
        n = len(l_sample["sentences"])
        labels = [0] * n
        preds = [0] * n
        for a in l_sample.get("action_ids", []):
            labels[a["id"] - 1] = 1
        for a in p_sample.get("action_ids", []):
            preds[a["id"] - 1] = 1
        total_labels.extend(labels)
        total_preds.extend(preds)
    prf = seg_metrics.binary_prf(total_preds, total_labels)
    return {
        "score": prf["f1"],
        "precision": prf["precision"],
        "recall": prf["recall"],
        "f1-score": prf["f1"],
    }


TRACK_EVALUATORS = {
    "topic_segmentation": topic_segment_evaluate,
    "extractive_summarization": extractive_summarization_evaluate,
    "topic_title_generation": topic_title_generation_evaluate,
    "keyphrase_extraction": keyphrase_extraction_evaluate,
    "action_item_detection": action_item_detection_evaluate,
}


def evaluate_files(task: str, label_file: str, pred_file: str) -> Dict:
    return TRACK_EVALUATORS[task](read_jsonl(label_file), read_jsonl(pred_file))
