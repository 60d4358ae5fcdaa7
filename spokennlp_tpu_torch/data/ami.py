"""AMI meeting corpus processor: NXT XML annotations -> AID dataset files.

The port's copy of ``spokennlp_tpu/data/ami.py`` (standard library and
numpy only; the same rows and files), itself a reimplementation of the
reference's data script (action-item-detection/data_script/
ami_process.py:1-855). Pipeline:

  words/<meet>.<spk>.words.xml        word tokens + times (disfmarker = "...")
  dialogueActs/<meet>.<spk>.dialog-act.xml   dialogue acts spanning word ids
  ontologies/da-types.xml             act type ids -> "Class#Type" glosses
  abstractive/<meet>.abssumm.xml      abstract/action/decision/problem items
  extractive/<meet>.summlink.xml      dialogue-act <-> abstract-item links

A dialogue act is an ACTION ITEM (label 1) iff a summlink ties it to an item
in the <actions> section (ami_process.py:344-379). Sentences are ordered by
(start_time, end_time) per meeting; examples carry left/right neighbor
context (optionally label-tagged) and optional similarity-ranked global
context; the official scenario-only split and positive/negative interleaving
balance are preserved.

Implementation is ElementTree-based (namespace-tolerant); the reference uses
minidom. Output: train/dev/test.txt TSVs with a configurable field list, the
format script/run_classifier.py's MeetProcessor consumes.
"""

from __future__ import annotations

import json
import os
import re
from collections import defaultdict
from typing import Dict, List, Optional, Sequence
from xml.etree import ElementTree as ET

NITE_NS = "http://nite.sourceforge.net/"

# official scenario-only split (ami_process.py:552-568)
SCENARIO_SPLIT = {
    "train": (
        "ES2002", "ES2005", "ES2006", "ES2007", "ES2008", "ES2009", "ES2010",
        "ES2012", "ES2013", "ES2015", "ES2016", "IS1000", "IS1001", "IS1002",
        "IS1003", "IS1004", "IS1005", "IS1006", "IS1007", "TS3005", "TS3008",
        "TS3009", "TS3010", "TS3011", "TS3012",
    ),
    "dev": ("ES2003", "ES2011", "IS1008", "TS3004", "TS3006"),
    "test": ("ES2004", "ES2014", "IS1009", "TS3003", "TS3007"),
}


def _attr(node, name: str) -> str:
    """Attribute lookup tolerant of the nite: namespace prefix."""
    for key in (f"{{{NITE_NS}}}{name}", f"nite:{name}", name):
        v = node.get(key)
        if v is not None:
            return v
    return ""


def _local(tag: str) -> str:
    return tag.rsplit("}", 1)[-1]


def _href_ids(href: str) -> List[str]:
    """'file.xml#id(a)..id(b)' -> ['a', 'b']; single id -> one element."""
    frag = href.strip().split("#", 1)[-1]
    return re.findall(r"id\(([^)]*)\)", frag)


def parse_abstractive(path: str) -> Dict[str, Dict[str, str]]:
    """abssumm.xml -> {"abstract"/"action"/"decision"/"problem": {id: text}}."""
    root = ET.parse(path).getroot()
    out = {"abstract": {}, "action": {}, "decision": {}, "problem": {}}
    section_map = {
        "abstract": "abstract",
        "actions": "action",
        "decisions": "decision",
        "problems": "problem",
    }
    for section in root.iter():
        key = section_map.get(_local(section.tag))
        if key is None:
            continue
        for child in list(section):
            cid = _attr(child, "id")
            text = (child.text or "").strip()
            if cid:
                out[key][cid] = text
    return out


def parse_extractive(path: str) -> Dict[str, List[str]]:
    """summlink.xml -> dialogue_act_id -> [abstract item ids]."""
    root = ET.parse(path).getroot()
    links: Dict[str, List[str]] = defaultdict(list)
    for link in root.iter():
        if _local(link.tag) != "summlink":
            continue
        da_id = abs_id = None
        for pointer in list(link):
            role = pointer.get("role", "")
            ids = _href_ids(pointer.get("href", ""))
            if not ids:
                continue
            if role == "extractive":
                da_id = ids[0]
            elif role == "abstractive":
                abs_id = ids[0]
        if da_id and abs_id:
            links[da_id].append(abs_id)
    return dict(links)


def parse_da_types(path: str) -> Dict[str, str]:
    """ontologies/da-types.xml -> type id -> 'Class#Type' gloss."""
    root = ET.parse(path).getroot()
    out = {}
    for cls in root.iter():
        if _local(cls.tag) != "da-type":
            continue
        cls_gloss = cls.get("gloss", "")
        for sub in list(cls):
            if _local(sub.tag) != "da-type":
                continue
            out[_attr(sub, "id")] = f"{cls_gloss}#{sub.get('gloss', '')}"
    return out


def parse_words(path: str) -> Dict[int, Dict]:
    """words.xml -> word index -> {word, start_time, end_time}.

    <w> nodes carry text; <disfmarker> renders as "..." (ami_process.py:
    232-243); other node kinds (vocalsound, gap...) contribute empty text.
    Missing times inherit the previous word's end time (the reference
    hardcodes a patch table for these; inheritance covers the same holes
    without the table).
    """
    root = ET.parse(path).getroot()
    out: Dict[int, Dict] = {}
    prev_end = 0.0
    for node in root.iter():
        tag = _local(node.tag)
        if tag not in ("w", "disfmarker"):
            continue
        m = re.findall(r"words(\d+)$", _attr(node, "id"))
        if len(m) != 1:
            continue
        wid = int(m[0])
        word = (node.text or "").strip() if tag == "w" else "..."
        st = node.get("starttime")
        en = node.get("endtime", st)
        start = float(st) if st is not None else prev_end
        end = float(en) if en is not None else start
        prev_end = end
        out[wid] = {"word": word, "start_time": start, "end_time": end}
    return out


def parse_dialogue_acts(path: str, da_types: Optional[Dict[str, str]] = None) -> Dict[str, Dict]:
    """dialog-act.xml -> act id -> {dact_types, start_id, end_id, meeting,
    speaker} sorted by word span."""
    base = os.path.basename(path).split(".")
    meeting, speaker = base[0], base[1] if len(base) > 1 else ""
    root = ET.parse(path).getroot()
    out: Dict[str, Dict] = {}
    for act in root.iter():
        if _local(act.tag) != "dact":
            continue
        da_id = _attr(act, "id")
        da_type = "Unlab#Unlab"
        span = None
        for child in list(act):
            tag = _local(child.tag)
            if tag == "pointer":
                ids = _href_ids(child.get("href", ""))
                if ids and da_types:
                    da_type = da_types.get(ids[0], "Unlab#Unlab")
            elif tag == "child":
                ids = _href_ids(child.get("href", ""))
                wids = []
                for i in ids:
                    m = re.findall(r"words(\d+)$", i)
                    if m:
                        wids.append(int(m[0]))
                if wids:
                    span = (wids[0], wids[-1] if len(wids) > 1 else wids[0])
        if span is None:
            continue
        out[da_id] = {
            "dact_ids": da_id,
            "dact_types": da_type,
            "start_id": span[0],
            "end_id": span[1],
            "meeting_name": meeting,
            "speaker_name": speaker,
            "data_source": f"AMI#{meeting[:2]}",
        }
    return dict(sorted(out.items(), key=lambda kv: (kv[1]["start_id"], kv[1]["end_id"])))


def attach_words(dacts: Dict[str, Dict], words: Dict[int, Dict]) -> Dict[str, Dict]:
    """Join each act's word span into a sentence + time span
    (ami_process.py:282-316)."""
    for da in dacts.values():
        toks, starts, ends = [], [], []
        for wid in range(da["start_id"], da["end_id"] + 1):
            w = words.get(wid)
            if w is None:
                continue
            toks.append(w["word"])
            starts.append(w["start_time"])
            ends.append(w["end_time"])
        da["sentence"] = " ".join(t for t in toks if t)
        da["start_time"] = starts[0] if starts else 0.0
        da["end_time"] = ends[-1] if ends else 0.0
    return dacts


def attach_action_labels(
    dacts: Dict[str, Dict],
    links: Dict[str, List[str]],
    abstracts: Dict[str, Dict[str, str]],
) -> Dict[str, Dict]:
    """label 1 iff a summlink ties the act to an <actions> item
    (ami_process.py:344-379)."""
    actions = abstracts["action"]
    for da_id, da in dacts.items():
        da["action_label"] = 0
        da["action_description"] = ""
        for abs_id in links.get(da_id, []):
            if abs_id in actions:
                da["action_label"] = 1
                da["action_description"] = actions[abs_id]
                break
    return dacts


def meeting_sentences(dacts: Dict[str, Dict]) -> List[Dict]:
    """Non-empty sentences ordered by time; 1-based sentence_id."""
    rows = [dict(d) for d in dacts.values() if d.get("sentence", "").strip()]
    rows.sort(key=lambda d: (d["start_time"], d["end_time"]))
    for i, r in enumerate(rows):
        r["sentence_id"] = i + 1
    return rows


def meeting_has_actions(abstracts, links) -> bool:
    """A meeting is usable iff at least one linked action item exists
    (is_valid_meeting, ami_process.py:390-416)."""
    if not abstracts["action"]:
        return False
    linked = {a for ids in links.values() for a in ids}
    return any(a in linked for a in abstracts["action"])


def which_split(meeting_name: str) -> str:
    prefix = meeting_name[:6]
    for split, meets in SCENARIO_SPLIT.items():
        if prefix in meets:
            return split
    return "none"


def add_context_fields(
    rows: List[Dict],
    num_left: int = 2,
    num_right: int = 2,
    num_global: int = 2,
    add_context_label: bool = True,
    context_sep: str = "###",
    context_label_sep: str = "@@@",
    similarity_map: Optional[Dict] = None,
) -> List[Dict]:
    """left/right neighbor context (optionally '<sent>@@@<label>' tagged) and
    similarity-ranked global context (ami_process.py:613-698). Empty context
    renders as the separator itself, as the reference writes it."""
    by_meet: Dict[str, Dict[int, Dict]] = defaultdict(dict)
    for r in rows:
        by_meet[r["meeting_name"]][r["sentence_id"]] = r

    def span(item):
        if add_context_label:
            return f"{item['sentence']}{context_label_sep}{item['action_label']}"
        return item["sentence"]

    for r in rows:
        meet = by_meet[r["meeting_name"]]
        sid = r["sentence_id"]
        left = [
            span(meet[i])
            for i in range(sid - 1, sid - num_left - 1, -1)
            if i in meet
        ]
        right = [
            span(meet[i])
            for i in range(sid + 1, sid + num_right + 1)
            if i in meet
        ]
        r["left_context"] = context_sep.join(left) if left else context_sep
        r["right_context"] = context_sep.join(right) if right else context_sep
        r["document_length"] = len(meet)
        if similarity_map is not None:
            ranked = (similarity_map.get(r["meeting_name"], {}) or {}).get(
                str(sid)
            )
            glob = []
            for entry in (ranked or [])[:num_global]:
                if entry.get("score", 0.0) == 0.0:
                    continue
                item = meet.get(entry["idx"])
                if item is not None:
                    glob.append(span(item))
            r["global_context"] = context_sep.join(glob) if glob else context_sep
    return rows


def balance_by_interleaving(rows: List[Dict]) -> List[Dict]:
    """Interleave the minority class evenly through the majority
    (balance_data_list, ami_process.py:700-729)."""
    pos = [r for r in rows if r["action_label"] == 1]
    neg = [r for r in rows if r["action_label"] == 0]
    big, small = (pos, neg) if len(pos) > len(neg) else (neg, pos)
    if not small:
        return list(big)
    times = len(big) // len(small)
    out: List[Dict] = []
    j = 0
    for s in small:
        out.append(s)
        for _ in range(times):
            if j < len(big):
                out.append(big[j])
                j += 1
    out.extend(big[j:])
    return out


DEFAULT_FIELDS = (
    "sentence", "action_label", "line_id", "sentence_id", "document_length",
    "left_context", "right_context",
)


def write_tsv(rows: Sequence[Dict], path: str, fields=DEFAULT_FIELDS,
              default_value: str = "###"):
    with open(path, "w", encoding="utf-8") as f:
        for r in rows:
            vals = [str(r.get(k, "")).strip() or default_value for k in fields]
            f.write("\t".join(vals) + "\n")


def process_ami_corpus(
    ami_dir: str,
    out_dir: str,
    num_left: int = 2,
    num_right: int = 2,
    num_global: int = 2,
    similarity_file: Optional[str] = None,
    fields: Optional[Sequence[str]] = None,
    seed: int = 2021,
) -> Dict[str, List[Dict]]:
    """Full corpus build: every meeting/speaker -> labeled sentences ->
    context fields -> scenario split -> balanced/shuffled train TSV + dev/test
    TSVs (ami_process.py:809-843). Returns the split row lists."""
    import numpy as np

    word_dir = os.path.join(ami_dir, "words")
    dact_dir = os.path.join(ami_dir, "dialogueActs")
    abst_dir = os.path.join(ami_dir, "abstractive")
    link_dir = os.path.join(ami_dir, "extractive")
    onto = os.path.join(ami_dir, "ontologies", "da-types.xml")
    da_types = parse_da_types(onto) if os.path.exists(onto) else {}

    meet2speakers: Dict[str, List[str]] = defaultdict(list)
    for fname in sorted(os.listdir(word_dir)):
        parts = fname.split(".")
        if len(parts) >= 3 and parts[-1] == "xml":
            meet2speakers[parts[0]].append(parts[1])

    all_rows: List[Dict] = []
    for meet, speakers in sorted(meet2speakers.items()):
        abst_f = os.path.join(abst_dir, f"{meet}.abssumm.xml")
        link_f = os.path.join(link_dir, f"{meet}.summlink.xml")
        if not (os.path.exists(abst_f) and os.path.exists(link_f)):
            continue
        abstracts = parse_abstractive(abst_f)
        links = parse_extractive(link_f)
        if not meeting_has_actions(abstracts, links):
            continue
        dacts: Dict[str, Dict] = {}
        for spk in sorted(speakers):
            wf = os.path.join(word_dir, f"{meet}.{spk}.words.xml")
            df = os.path.join(dact_dir, f"{meet}.{spk}.dialog-act.xml")
            if not (os.path.exists(wf) and os.path.exists(df)):
                continue
            das = parse_dialogue_acts(df, da_types)
            dacts.update(attach_words(das, parse_words(wf)))
        dacts = attach_action_labels(dacts, links, abstracts)
        all_rows.extend(meeting_sentences(dacts))

    # corpus-wide line ids in (source, meeting, sentence) order
    source_order = {f"AMI#{t}": i for i, t in enumerate(
        ("IS", "ES", "TS", "IB", "EN", "IN"))}
    all_rows.sort(key=lambda r: (
        source_order.get(r["data_source"], 99), r["meeting_name"],
        r["sentence_id"]))
    for i, r in enumerate(all_rows):
        r["line_id"] = i

    similarity_map = None
    if similarity_file and os.path.exists(similarity_file):
        with open(similarity_file, encoding="utf-8") as f:
            similarity_map = json.load(f)
    fields = tuple(fields) if fields else DEFAULT_FIELDS
    if similarity_map is not None and "global_context" not in fields:
        fields = fields + ("global_context",)
    add_context_fields(
        all_rows, num_left, num_right, num_global,
        similarity_map=similarity_map,
    )

    os.makedirs(out_dir, exist_ok=True)
    splits: Dict[str, List[Dict]] = {"train": [], "dev": [], "test": []}
    for r in all_rows:
        s = which_split(r["meeting_name"])
        if s in splits:
            splits[s].append(r)

    rng = np.random.default_rng(seed)
    train = balance_by_interleaving(splits["train"])
    order = rng.permutation(len(train))
    train = [train[i] for i in order]
    write_tsv(train, os.path.join(out_dir, "train.txt"), fields)
    write_tsv(splits["dev"], os.path.join(out_dir, "dev.txt"), fields)
    write_tsv(splits["test"], os.path.join(out_dir, "test.txt"), fields)
    return {"train": train, "dev": splits["dev"], "test": splits["test"]}
