"""MUG Track 2: extractive summarization as key-sentence token classification.

Counterpart of ``spokennlp_tpu/projects/mug/extractive_summarization.py``
(the featurizer and the rouge evaluation are the same host code; the
prediction loop runs the PyTorch model).

Reimplements the reference pipeline (reference: alimeeting4mug/src/
extractive_summarization/ponet_extractive_summarization.py): the same
EOS-marked PoNet windowing as Track 1, with per-sentence key/not-key labels
built under the multi-annotator strategies (:262-333), and multi-reference
rouge (avg + max) evaluation (:853-979). Works at topic level (one example
per topic) or meeting (doc) level.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from spokennlp_tpu_torch.configs import WindowingConfig
from spokennlp_tpu_torch.eval.rouge import multi_reference_rouge
from spokennlp_tpu_torch.projects.mug.data import parse_extractive_summarization
from spokennlp_tpu_torch.projects.mug.topic_segmentation import (
    EosWindow,
    predict_window_logits,
    stack_eos_windows,
    window_document_eos,
)
from spokennlp_tpu_torch.utils.tokenization import BasicTokenizer

IGNORE = -100
_tok = BasicTokenizer()


def featurize_es_examples(
    meetings: Sequence[Dict],
    tokenize_fn: Callable[[str], List[int]],
    cfg: WindowingConfig,
    eos_token_id: int,
    level: str = "topic",
    annotator_strategy: str = "single",
):
    """Meetings -> (examples, windows). Key labels: 1 = key sentence.

    Label convention for the classifier matches Track 1's head: label 0 =
    positive (key sentence, like B-EOP), 1 = negative — so the shared
    token-classification machinery and metrics apply unchanged.
    """
    examples: List[Dict] = []
    windows: List[EosWindow] = []
    for m in meetings:
        parsed = parse_extractive_summarization(
            m, level=level, annotator_strategy=annotator_strategy
        )
        for ex in parsed:
            eid = len(examples)
            # key=1 -> class 0 (positive); other -> class 1
            labels = [0 if k == 1 else 1 for k in ex["key_labels"]]
            sent_tokens = [tokenize_fn(s) for s in ex["sentences"]]
            ws = window_document_eos(
                sent_tokens, labels, cfg, eos_token_id, example_id=eid
            )
            windows.extend(ws)
            examples.append(ex)
    return examples, windows


def predict_key_sentences(
    model,
    examples: Sequence[Dict],
    windows: Sequence[EosWindow],
    batch_size: int = 8,
    top_ratio: Optional[float] = None,
) -> List[List[int]]:
    """Per example: LOCAL 1-based key-sentence ids (within its span)."""
    logits_all = predict_window_logits(model, stack_eos_windows(list(windows)), batch_size)

    scores: List[Dict[int, float]] = [dict() for _ in examples]
    for w, lg in zip(windows, logits_all):
        live = w.labels != IGNORE
        probs = np.exp(lg - lg.max(-1, keepdims=True))
        probs = probs / probs.sum(-1, keepdims=True)
        for sid, p in zip(w.sent_ids, probs[live][:, 0]):
            scores[w.example_id][sid] = float(p)

    out: List[List[int]] = []
    for ex, sc in zip(examples, scores):
        if top_ratio is not None and sc:
            k = max(1, int(round(len(ex["sentences"]) * top_ratio)))
            chosen = sorted(sc, key=lambda i: -sc[i])[:k]
        else:
            chosen = [i for i, p in sc.items() if p >= 0.5]
        out.append(sorted(i + 1 for i in chosen))
    return out


def evaluate_es_rouge(
    examples: Sequence[Dict], predictions: Sequence[Sequence[int]]
) -> Dict[str, float]:
    """Multi-reference rouge over predicted key-sentence summaries
    (reference compute_metrics :853-979)."""
    preds, refs = [], []
    for ex, key_ids in zip(examples, predictions):
        sents = ex["sentences"]
        pred_text = "".join(sents[i - 1] for i in key_ids if 1 <= i <= len(sents))
        preds.append(" ".join(_tok.tokenize(pred_text)))
        multi = []
        for ref_ids in ex["multi_ref_key_sentences"]:
            offset = ex["topic_span"][0]
            ref_text = "".join(
                sents[int(i) - 1 - offset]
                for i in ref_ids
                if 0 <= int(i) - 1 - offset < len(sents)
            )
            multi.append(" ".join(_tok.tokenize(ref_text)))
        refs.append(multi or [""])
    return multi_reference_rouge(preds, refs)
