"""Corpus converters and loaders for the topic-segmentation datasets.

The port's own copy of ``spokennlp_tpu/data/corpora.py`` (same behaviour;
imports only the standard library, and nltk's ``sent_tokenize`` where it
imports): raw corpora (WikiSection json, wiki-727k / wiki-50 folders,
WikiElements) -> unified jsonl ``{"sentences": [...], "labels": [...]}``
where label 1 = final sentence of a topic, 0 = final sentence of a
paragraph, -100 = mid-paragraph sentence (the reference's
preprocess_data.py:19-221); jsonl -> examples with label ids -> tokenized
documents for the windowing featurizer; and the config.ini dataset-name ->
folder mapping.
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


SECTION_FLAG = "========"  # wiki-727k / wiki-50 section marker prefix


def sentence_split(text: str) -> List[str]:
    """Paragraph-preserving sentence split. Uses nltk punkt when available
    (the reference's sent_tokenize), falling back to a regex splitter."""
    try:
        from nltk.tokenize import sent_tokenize

        return sent_tokenize(text)
    except (ImportError, LookupError):  # no nltk, or no punkt data
        import re

        parts = re.split(r"(?<=[.!?])\s+", text.strip())
        return [p for p in parts if p]


def section_to_sentences(sec_text: str):
    """One section -> (sentences, labels): paragraph ends 0, topic end 1,
    others -100 (reference tokenize_method, preprocess_data.py:19-33)."""
    paragraphs = [p for p in sec_text.split("\n") if p != ""]
    sents: List[str] = []
    labels: List[int] = []
    for p in paragraphs:
        p_sents = sentence_split(p)
        if not p_sents:
            continue
        sents.extend(p_sents)
        labels.extend([IGNORE] * (len(p_sents) - 1) + [0])
    if labels:
        labels[-1] = 1
    return sents, labels


def convert_wikisection_file(in_file: str) -> List[Dict]:
    """WikiSection raw json -> unified examples (:34-77)."""
    out = []
    with open(in_file) as f:
        data = json.load(f)
    for example in data:
        text, annotations = example["text"], example["annotations"]
        sentences, labels = [], []
        section_topics, sentence_topics = [], []
        ok = True
        for anno in annotations:
            sec_text = text[anno["begin"] : anno["begin"] + anno["length"]]
            s, l = section_to_sentences(sec_text)
            if len(s) != len(l):
                ok = False
                break
            sentences += s
            labels += l
            section_topics.append(anno["sectionLabel"])
            sentence_topics += [anno["sectionLabel"]] * len(s)
        if not ok or not sentences:
            continue
        out.append(
            {
                "sentences": sentences,
                "labels": labels,
                "section_topic_labels": section_topics,
                "sentence_topic_labels": sentence_topics,
            }
        )
    return out


def convert_choi_style_file(path: str) -> Dict:
    """One wiki-727k / wiki-50 file ('========'-delimited sections) -> one
    example (:129-168). Sentence labels: 0 within section, 1 at section end."""
    with open(path) as f:
        lines = f.readlines()
    flag_idx = [i for i, l in enumerate(lines) if l.startswith(SECTION_FLAG)]
    flag_idx.append(len(lines))
    sentences, labels = [], []
    for i in range(len(flag_idx) - 1):
        start, end = flag_idx[i] + 1, flag_idx[i + 1]
        if start == end:
            continue
        sec = [l.strip() for l in lines[start:end]]
        sentences += sec
        labels += [0] * (len(sec) - 1) + [1]
    return {"file": path, "sentences": sentences, "labels": labels}


def convert_wiki_folder(folder: str, out_file: str):
    all_files = []
    for root, _, files in os.walk(folder):
        for name in sorted(files):
            all_files.append(os.path.join(root, name))
    with open(out_file, "w") as f:
        for path in sorted(all_files):
            ex = convert_choi_style_file(path)
            f.write(json.dumps(ex) + "\n")


def convert_wiki_elements(text_file: str, seg_file: str, out_file: str):
    """WikiElements paragraph-level corpus (:184-221)."""
    with open(seg_file) as f:
        seg_lines = f.readlines()
    with open(text_file) as f:
        para_lines = f.readlines()
    assert len(seg_lines) == len(para_lines)
    docs: Dict[str, List[Dict]] = {}
    for seg_line, para_line in zip(seg_lines, para_lines):
        doc_index, para_index, topic_title = seg_line.strip().split(",")[:3]
        docs.setdefault(doc_index, []).append(
            {"topic_title": topic_title, "para_text": para_line.strip()}
        )
    with open(out_file, "w") as f:
        for doc_index in sorted(docs.keys()):
            paras = docs[doc_index]
            labels = []
            cur = ""
            for i in range(len(paras) - 1, -1, -1):
                labels.insert(0, 1 if paras[i]["topic_title"] != cur else 0)
                cur = paras[i]["topic_title"]
            f.write(
                json.dumps(
                    {"sentences": [p["para_text"] for p in paras], "labels": labels}
                )
                + "\n"
            )


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
