"""ROUGE-1/2/L metrics (self-contained; no external rouge package).

The port's own copy of ``spokennlp_tpu/eval/rouge.py`` (same behaviour; imports
only the port, numpy and the standard library).

Matches the semantics of the `rouge` pypi package (pltrdy/rouge) that the
reference uses for the MUG challenge (reference: alimeeting4mug/src/utils/
challenge_evaluate.py:23,29 and metrics/rouge/rouge.py:102-135):

- inputs are pre-tokenized, space-joined strings;
- ROUGE-N uses DISTINCT n-grams (set semantics, like pltrdy/rouge);
- ROUGE-L uses LCS over the token sequences;
- each metric reports f/p/r; ``avg=True`` averages over pairs.
"""

from __future__ import annotations

from typing import Dict, List, Sequence


def _ngrams(tokens: Sequence[str], n: int) -> set:
    return {tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1)}


def _prf(overlap: float, hyp_count: float, ref_count: float) -> Dict[str, float]:
    p = overlap / hyp_count if hyp_count else 0.0
    r = overlap / ref_count if ref_count else 0.0
    f = 2 * p * r / (p + r) if p + r else 0.0
    return {"f": f, "p": p, "r": r}


def rouge_n(hyp: str, ref: str, n: int) -> Dict[str, float]:
    h = _ngrams(hyp.split(), n)
    r = _ngrams(ref.split(), n)
    return _prf(len(h & r), len(h), len(r))


def _lcs_len(a: Sequence[str], b: Sequence[str]) -> int:
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for i in range(1, len(a) + 1):
        cur = [0] * (len(b) + 1)
        ai = a[i - 1]
        for j in range(1, len(b) + 1):
            if ai == b[j - 1]:
                cur[j] = prev[j - 1] + 1
            else:
                cur[j] = max(prev[j], cur[j - 1])
        prev = cur
    return prev[-1]


def rouge_l(hyp: str, ref: str) -> Dict[str, float]:
    h = hyp.split()
    r = ref.split()
    lcs = _lcs_len(h, r)
    return _prf(lcs, len(h), len(r))


def rouge_scores(
    hypotheses: Sequence[str], references: Sequence[str], avg: bool = True
):
    """`Rouge().get_scores`-compatible output.

    avg=True -> {"rouge-1": {"f","p","r"}, "rouge-2": ..., "rouge-l": ...};
    avg=False -> list of per-pair dicts.
    """
    assert len(hypotheses) == len(references)
    per_pair: List[Dict] = []
    for h, r in zip(hypotheses, references):
        per_pair.append(
            {
                "rouge-1": rouge_n(h, r, 1),
                "rouge-2": rouge_n(h, r, 2),
                "rouge-l": rouge_l(h, r),
            }
        )
    if not avg:
        return per_pair
    out = {}
    for key in ("rouge-1", "rouge-2", "rouge-l"):
        out[key] = {
            m: sum(p[key][m] for p in per_pair) / max(len(per_pair), 1)
            for m in ("f", "p", "r")
        }
    return out


def multi_reference_rouge(
    predictions: Sequence[str], multi_references: Sequence[Sequence[str]]
) -> Dict[str, float]:
    """Average + max over annotator references (reference: challenge_evaluate.
    py:compute_es_rouge:230-262). Strings must already be tokenized and
    space-joined."""
    import numpy as np

    avg_scores, max_scores = [], []
    for pred, refs in zip(predictions, multi_references):
        per_ref = []
        for ref in refs:
            s = rouge_scores([pred], [ref])
            flat = {
                f"{k1}_{k2}": s[k1][k2] for k1 in s for k2 in s[k1]
            }
            flat["score"] = s["rouge-1"]["f"]
            per_ref.append(flat)
        best = max(per_ref, key=lambda x: x["rouge-l_f"])
        max_scores.append(best)
        avg_scores.append(
            {k: float(np.mean([p[k] for p in per_ref])) for k in best.keys()}
        )
    out = {}
    keys = avg_scores[0].keys() if avg_scores else []
    for k in keys:
        out[f"multi-ref-average_{k}"] = float(np.mean([s[k] for s in avg_scores]))
        out[f"multi-ref-max_{k}"] = float(np.mean([s[k] for s in max_scores]))
    return out
