"""Corpus loaders for the topic-segmentation datasets.

The port's own copy of the loaders of ``spokennlp_tpu/data/corpora.py``
(same behaviour; imports only the standard library): unified jsonl
``{"sentences": [...], "labels": [...]}`` -> examples with label ids ->
tokenized documents for the windowing featurizer, and the config.ini
dataset-name -> folder mapping. The raw-corpus converters, which produce the
jsonl files once and may use nltk, stay in the JAX package.
"""

from __future__ import annotations

import configparser
import json
import os
from typing import Callable, Dict, Iterable, List, Optional, Sequence

LABEL_EOP = 0  # "B-EOP" in the string label space
LABEL_O = 1  # "O"
IGNORE = -100

# raw-file label space: 1 = end of topic, 0 = end of paragraph, -100 = other
_RAW_TO_ID = {1: LABEL_EOP, "1": LABEL_EOP, 0: LABEL_O, "0": LABEL_O}


# ------------------------------------------------------------------- loaders


def load_jsonl_examples(path: str) -> List[Dict]:
    """Unified jsonl -> examples with integer label ids (B-EOP=0, O=1,
    unlabeled=-100), mirroring the HF builders' label_map (wiki_section.py:
    73-87)."""
    out = []
    with open(path) as f:
        for example_id, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            ex = json.loads(line)
            labels = [
                _RAW_TO_ID[v] if v in _RAW_TO_ID else IGNORE for v in ex["labels"]
            ]
            out.append(
                {
                    "example_id": example_id,
                    "sentences": ex["sentences"],
                    "labels": labels,
                }
            )
    return out


def load_video_jsonl_examples(path: str) -> List[Dict]:
    """avlecture / clvts video-topic-seg jsonl (reference builders:
    mmvts/src/datasets/avlecture/avlecture.py:26-82, clvts/clvts.py):
    rows {"example_id": "...", "text": [clip transcripts], "labels": [...]}
    where raw label 1 = end clip of topic -> B-EOP(0); avlecture example ids
    carry the lecture name after '@@'."""
    out = []
    with open(path) as f:
        for example_id, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            ex = json.loads(line)
            raw_id = str(ex.get("example_id", example_id))
            lecture = raw_id.split("@@")[1] if "@@" in raw_id else raw_id
            labels = [
                _RAW_TO_ID[v] if v in _RAW_TO_ID else IGNORE for v in ex["labels"]
            ]
            row = {
                "example_id": example_id,
                "lecture": lecture,
                "sentences": ex["text"],
                "labels": labels,
            }
            # per-clip [start, end] seconds when present ("stet" in the
            # reference data schema, mmvts/src/evaluate.py:96-99) — the
            # time-aware metrics (bs@30, mIoU) need the real time axis
            if "stet" in ex:
                row["clip_end_seconds"] = [float(st[1]) for st in ex["stet"]]
            elif "clip_end_seconds" in ex:
                row["clip_end_seconds"] = [float(v) for v in ex["clip_end_seconds"]]
            out.append(row)
    return out


def tokenize_examples(
    examples: Sequence[Dict], tokenize_fn: Callable[[str], List[int]]
) -> List[Dict]:
    """Attach token ids: -> {"sent_token_ids", "labels", "example_id"}."""
    out = []
    for ex in examples:
        out.append(
            {
                "example_id": ex["example_id"],
                "sent_token_ids": [tokenize_fn(s) for s in ex["sentences"]],
                "labels": ex["labels"],
                "sentences": ex["sentences"],
            }
        )
    return out


def dataset_folder_mapping(config_path: str) -> Dict[str, str]:
    """config.ini [mapping] section: dataset name -> data folder
    (preprocess_data.py:227-231)."""
    cfg = configparser.ConfigParser()
    cfg.read(config_path)
    return dict(cfg["mapping"])


DATASET_SPLITS = {
    "wiki_section": ("train.jsonl", "dev.jsonl", "test.jsonl"),
    "wiki_section_disease": ("train.jsonl", "dev.jsonl", "test.jsonl"),
    "wiki_section_city": ("train.jsonl", "dev.jsonl", "test.jsonl"),
    "wiki727k": ("train.jsonl", "dev.jsonl", "test.jsonl"),
    "wiki50": (None, None, "test.jsonl"),
    "wiki_elements": (None, None, "test.jsonl"),
    # MMVTS video corpora (clip transcripts; features cached separately)
    "avlecture": ("train.jsonl", "dev.jsonl", "test.jsonl"),
    "clvts": ("train.jsonl", "dev.jsonl", "test.jsonl"),
}

_SPLIT_LOADERS = {
    "avlecture": "video",
    "clvts": "video",
}


def load_dataset_splits(name: str, data_dir: str) -> Dict[str, List[Dict]]:
    train_f, dev_f, test_f = DATASET_SPLITS[name]
    loader = (
        load_video_jsonl_examples
        if _SPLIT_LOADERS.get(name) == "video"
        else load_jsonl_examples
    )
    splits = {}
    for split, fname in (("train", train_f), ("validation", dev_f), ("test", test_f)):
        if fname and os.path.exists(os.path.join(data_dir, fname)):
            splits[split] = loader(os.path.join(data_dir, fname))
    return splits
