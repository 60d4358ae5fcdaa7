"""WER / CER metrics (jiwer-free Levenshtein implementation).

The port's own copy of ``spokennlp_tpu/eval/asr_metrics.py`` (the same
functions and numbers). The reference wraps jiwer through evaluate.Metric
(reference: sld/utils/wer/wer.py:78-106, sld/utils/cer/cer.py). Same
definitions: corpus-level edit-distance over words (WER) or characters
(CER), totals pooled across the corpus (sum of edits / sum of reference
lengths).
"""

from __future__ import annotations

from typing import Sequence


def edit_distance(ref: Sequence, hyp: Sequence) -> int:
    """Levenshtein distance with substitutions/insertions/deletions = 1."""
    if not ref:
        return len(hyp)
    if not hyp:
        return len(ref)
    prev = list(range(len(hyp) + 1))
    for i in range(1, len(ref) + 1):
        cur = [i] + [0] * len(hyp)
        for j in range(1, len(hyp) + 1):
            cost = 0 if ref[i - 1] == hyp[j - 1] else 1
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + cost)
        prev = cur
    return prev[-1]


def wer(predictions: Sequence[str], references: Sequence[str]) -> float:
    """Word error rate pooled over the corpus."""
    edits = 0
    total = 0
    for pred, ref in zip(predictions, references):
        r = ref.split()
        h = pred.split()
        edits += edit_distance(r, h)
        total += len(r)
    return edits / total if total else 0.0


def cer(predictions: Sequence[str], references: Sequence[str]) -> float:
    """Character error rate pooled over the corpus."""
    edits = 0
    total = 0
    for pred, ref in zip(predictions, references):
        edits += edit_distance(list(ref), list(pred))
        total += len(ref)
    return edits / total if total else 0.0
