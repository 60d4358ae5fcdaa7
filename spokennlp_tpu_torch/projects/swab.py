"""SWAB: Spoken-to-Written conversion benchmark (data + evaluation).

The port's copy of ``spokennlp_tpu/projects/swab.py`` (host code: the same
documents, pairs and scores, on the port's rouge and tokenizer). The
reference ships SWAB as a data-only project (reference: swab/README.md,
swab/example/swab_example.json) — 60 document-level ASR transcripts with
paragraph structure and written-style targets for the CoS2W task. This module
provides the loader for that schema and the evaluation surface the paper
reports (ROUGE against written targets; paragraph-level alignment), so
seq2seq models from models/seq2seq.py can be trained/evaluated on it.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence

from spokennlp_tpu_torch.eval.rouge import rouge_scores
from spokennlp_tpu_torch.utils.tokenization import BasicTokenizer

_tok = BasicTokenizer()


def load_swab(path: str) -> List[Dict]:
    """Load SWAB documents (a JSON array or jsonl of documents).

    Each document: {"meeting_key", "language", "dataset_domain",
    "sentences": [{"id", "s" (ASR), "s_gt" (gold transcript), "speaker",
    "start_time", "end_time"}], "paragraph_segment_ids": [{"id", "target"
    (written-style paragraph)}], ...}
    """
    with open(path) as f:
        text = f.read().strip()
    if text.startswith("["):
        docs = json.loads(text)
    else:
        docs = [json.loads(line) for line in text.splitlines() if line.strip()]
    return docs


def paragraph_pairs(doc: Dict, use_gt_transcript: bool = False) -> List[Dict]:
    """(spoken paragraph text, written target) pairs for CoS2W.

    Paragraph boundaries come from paragraph_segment_ids (1-based END
    sentence ids); ``target`` holds the annotated written-style paragraph.
    """
    sent_key = "s_gt" if use_gt_transcript else "s"
    sents = [s[sent_key] for s in doc["sentences"]]
    out = []
    prev = 0
    for para in doc.get("paragraph_segment_ids", []):
        end = int(para["id"])
        out.append(
            {
                "meeting_key": doc.get("meeting_key", ""),
                "source": "".join(sents[prev:end]),
                "target": para.get("target", ""),
                "span": (prev, end),
            }
        )
        prev = end
    return out


def evaluate_cos2w(
    predictions: Sequence[str], targets: Sequence[str]
) -> Dict[str, float]:
    """ROUGE-1/2/L F against the written-style targets (tokenized)."""
    hyp = [" ".join(_tok.tokenize(p)) for p in predictions]
    ref = [" ".join(_tok.tokenize(t)) for t in targets]
    s = rouge_scores(hyp, ref)
    return {
        "rouge-1_f": s["rouge-1"]["f"],
        "rouge-2_f": s["rouge-2"]["f"],
        "rouge-l_f": s["rouge-l"]["f"],
    }
