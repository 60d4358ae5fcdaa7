"""AliMeeting4MUG corpus parsing + submission file generation.

The port's own copy of ``spokennlp_tpu/projects/mug/data.py`` (same behaviour; imports
only the port, numpy and the standard library).

Reimplements the reference's data_parse_fn family and per-track
submit-file generators (reference: alimeeting4mug/src/topic_segment/
ponet_topic_segmentation.py:307-356, src/*/submit_file_generation.py).

Corpus format (one meeting per jsonl line):
  {"meeting_key": str,
   "sentences": [{"id": int, "s": str}, ...],
   "topic_segment_ids": [{"id": int, ("candidate": [...])}, ...],
   "paragraph_segment_ids"|"org_segment_id": [{"id": int}, ...],
   "action_ids": [{"id": int}, ...],
   "candidate": [{"key_sentence": [...], "key_word": [...], "title": ...}]}
Segment ids are 1-based sentence indices marking segment-END sentences.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence

LABEL_EOP = 0  # "B-EOP"
LABEL_O = 1  # "O"
IGNORE = -100


def read_jsonl(path: str) -> List[Dict]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def write_jsonl(path: str, samples: Sequence[Dict]):
    with open(path, "w") as f:
        for s in samples:
            f.write(json.dumps(s, ensure_ascii=False) + "\n")


def parse_topic_segmentation(meeting: Dict) -> Dict:
    """One meeting -> {sentences, labels} with the reference label scheme
    (ponet_topic_segmentation.py:307-356): paragraph-END sentences get a live
    label (O, or B-EOP when also a topic end); other sentences get IGNORE;
    the final sentence is forced B-EOP."""
    sentences = [s["s"] for s in meeting["sentences"]]
    n = len(sentences)
    topic_ids = [t["id"] for t in meeting.get("topic_segment_ids", [])]
    if not topic_ids or topic_ids[-1] < n:
        topic_ids = topic_ids + [n]
    para_key = "org_segment_id" if "org_segment_id" in meeting else "paragraph_segment_ids"
    para_ids = [p["id"] for p in meeting.get(para_key, [])]

    labels = [IGNORE] * n
    labels[-1] = LABEL_EOP
    for i in range(n):
        if (i + 1) in para_ids:
            labels[i] = LABEL_O
        if (i + 1) in topic_ids:
            labels[i] = LABEL_EOP
    return {
        "meeting_key": meeting.get("meeting_key", ""),
        "sentences": sentences,
        "labels": labels,
    }


def parse_extractive_summarization(
    meeting: Dict,
    level: str = "topic",
    annotator_strategy: str = "single",
    annotator_index: int = 0,
) -> List[Dict]:
    """Key-sentence labeling examples (reference:
    ponet_extractive_summarization.py:262-333 annotator strategies).

    level: "topic" -> one example per topic; "doc" -> one per meeting.
    annotator_strategy: "single" (one annotator), "union" (any annotator),
    "major_vote" (majority), "pool" (one example per annotator).
    """
    sentences = [s["s"] for s in meeting["sentences"]]
    out = []

    def key_sets(candidates):
        return [set(int(i) for i in c.get("key_sentence", [])) for c in candidates]

    def labels_from(sets, n_sent, offset=0):
        if not sets:
            return None
        if annotator_strategy == "single":
            chosen = [sets[min(annotator_index, len(sets) - 1)]]
        elif annotator_strategy == "union":
            chosen = [set().union(*sets)]
        elif annotator_strategy == "major_vote":
            votes = {}
            for s in sets:
                for i in s:
                    votes[i] = votes.get(i, 0) + 1
            chosen = [{i for i, v in votes.items() if v * 2 > len(sets)}]
        elif annotator_strategy == "pool":
            chosen = sets
        else:
            raise ValueError(annotator_strategy)
        outs = []
        for s in chosen:
            outs.append(
                [1 if (offset + j + 1) in s else 0 for j in range(n_sent)]
            )
        return outs

    if level == "topic":
        prev = 0
        for topic in meeting.get("topic_segment_ids", []):
            end = int(topic["id"])
            seg_sents = sentences[prev:end]
            sets = key_sets(topic.get("candidate", []))
            for lab in labels_from(sets, len(seg_sents), offset=prev) or []:
                out.append(
                    {
                        "meeting_key": meeting.get("meeting_key", ""),
                        "sentences": seg_sents,
                        "key_labels": lab,
                        "multi_ref_key_sentences": [sorted(s) for s in sets],
                        "topic_span": (prev, end),
                    }
                )
            prev = end
    else:
        sets = key_sets(meeting.get("candidate", []))
        for lab in labels_from(sets, len(sentences)) or []:
            out.append(
                {
                    "meeting_key": meeting.get("meeting_key", ""),
                    "sentences": sentences,
                    "key_labels": lab,
                    "multi_ref_key_sentences": [sorted(s) for s in sets],
                    "topic_span": (0, len(sentences)),
                }
            )
    return out


def parse_title_generation(meeting: Dict) -> List[Dict]:
    """(topic text, [candidate titles]) pairs per topic."""
    sentences = [s["s"] for s in meeting["sentences"]]
    out = []
    prev = 0
    for topic in meeting.get("topic_segment_ids", []):
        end = int(topic["id"])
        out.append(
            {
                "meeting_key": meeting.get("meeting_key", ""),
                "source": "".join(sentences[prev:end]),
                "titles": [c.get("title", "") for c in topic.get("candidate", [])],
                "topic_span": (prev, end),
            }
        )
        prev = end
    return out


def parse_action_items(meeting: Dict) -> Dict:
    """Sentence-level binary action labels."""
    sentences = [s["s"] for s in meeting["sentences"]]
    action_ids = {a["id"] for a in meeting.get("action_ids", [])}
    labels = [1 if (i + 1) in action_ids else 0 for i in range(len(sentences))]
    return {
        "meeting_key": meeting.get("meeting_key", ""),
        "sentences": sentences,
        "labels": labels,
    }


def parse_keyphrases(meeting: Dict) -> Dict:
    """All annotators' keyphrases flattened (challenge_evaluate.py:506-512)."""
    kws = [c.get("key_word", []) for c in meeting.get("candidate", [])]
    return {
        "meeting_key": meeting.get("meeting_key", ""),
        "sentences": [s["s"] for s in meeting["sentences"]],
        "key_words": [w for ww in kws for w in ww],
    }


# ------------------------------------------------------------- submissions


def topic_segmentation_submission(
    meeting_keys: Sequence[str], boundary_sentence_ids: Sequence[Sequence[int]]
) -> List[Dict]:
    """predictions -> submit jsonl rows: boundary ids are 1-based sentence ids."""
    return [
        {"meeting_key": mk, "topic_segment_ids": [{"id": int(i)} for i in ids]}
        for mk, ids in zip(meeting_keys, boundary_sentence_ids)
    ]


def extractive_summarization_submission(
    meeting_keys: Sequence[str],
    per_topic_key_sentences: Sequence[Sequence[Dict]],
    doc_key_sentences: Sequence[Sequence[int]],
) -> List[Dict]:
    out = []
    for mk, topics, doc_keys in zip(
        meeting_keys, per_topic_key_sentences, doc_key_sentences
    ):
        out.append(
            {
                "meeting_key": mk,
                "topic_segment_ids": [
                    {"id": int(t["id"]), "key_sentence": [int(i) for i in t["key_sentence"]]}
                    for t in topics
                ],
                "key_sentence": [int(i) for i in doc_keys],
            }
        )
    return out


def title_generation_submission(
    meeting_keys: Sequence[str], per_topic_titles: Sequence[Sequence[Dict]]
) -> List[Dict]:
    return [
        {
            "meeting_key": mk,
            "topic_segment_ids": [
                {"id": int(t["id"]), "title": t["title"]} for t in topics
            ],
        }
        for mk, topics in zip(meeting_keys, per_topic_titles)
    ]


def keyphrase_submission(
    meeting_keys: Sequence[str], key_words: Sequence[Sequence[str]]
) -> List[Dict]:
    return [
        {"meeting_key": mk, "key_word": list(kw)}
        for mk, kw in zip(meeting_keys, key_words)
    ]


def action_item_submission(
    meeting_keys: Sequence[str], action_sentence_ids: Sequence[Sequence[int]]
) -> List[Dict]:
    return [
        {"meeting_key": mk, "action_ids": [{"id": int(i)} for i in ids]}
        for mk, ids in zip(meeting_keys, action_sentence_ids)
    ]
