"""The port's copies of the host modules against the JAX package's, and the
port's isolation from the JAX package.

The copies (configs, tokenization, corpora, windowing, augmentation, CSSL
sampling, featurization, segmentation metrics, the CLI flag groups; the MUG
data parsers, EOS windowing, ES featuriser, rouge and challenge evaluator)
must give the same arrays and numbers as the modules they copy on one
corpus; and no module of ``spokennlp_tpu_torch``, nor ``chip_smoke.py``, may
load ``spokennlp_tpu``, ``jax`` or ``flax``.
"""

import argparse
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]


def _corpus(tmp_path):
    rng = np.random.default_rng(0)
    words = [f"w{i}" for i in range(300)] + ["Hello,", "world!", "naïve", "中文"]
    d = tmp_path / "wiki_section"
    d.mkdir(parents=True)
    for split, n in (("train.jsonl", 6), ("dev.jsonl", 2), ("test.jsonl", 3)):
        with open(d / split, "w") as f:
            for _ in range(n):
                ns = int(rng.integers(5, 40))
                sents = [" ".join(rng.choice(words, size=rng.integers(2, 25))) for _ in range(ns)]
                labels = [int(rng.random() < 0.2) for _ in range(ns)]
                labels[-1] = 1
                f.write(json.dumps({"sentences": sents, "labels": labels}) + "\n")
    return str(d)


def _assert_same(got, want, path="batch"):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{path}[{i}]")
    elif dataclasses.is_dataclass(want):
        _assert_same(dataclasses.asdict(got), dataclasses.asdict(want), path)
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=path)


def _docs(tmp_path, corpora):
    data = corpora.load_dataset_splits("wiki_section", _corpus(tmp_path))
    tok = lambda s: [1000 + sum(map(ord, w)) % 500 for w in s.split()] or [1000]
    return {k: corpora.tokenize_examples(v, tok) for k, v in data.items()}


def test_corpora_windowing_and_featurization_match_jax(tmp_path):
    from spokennlp_tpu import configs as jc
    from spokennlp_tpu.data import corpora as j_corpora
    from spokennlp_tpu.data import featurization as j_feat
    from spokennlp_tpu.data import windowing as j_win
    from spokennlp_tpu.data import windowing_fast as j_fast
    from spokennlp_tpu_torch import configs as tc
    from spokennlp_tpu_torch.data import corpora, featurization, windowing, windowing_fast

    want_docs, got_docs = _docs(tmp_path / "j", j_corpora), _docs(tmp_path / "t", corpora)
    _assert_same(got_docs, want_docs, "docs")
    docs = got_docs["train"]
    kw = dict(max_seq_length=64, cls_token_id=2, pad_token_id=0, bos_token_id=1)
    jw, tw = jc.WindowingConfig(**kw), tc.WindowingConfig(**kw)
    _assert_same(windowing_fast.window_documents_stacked(docs, tw),
                 j_fast.window_documents_stacked(docs, jw), "stacked")
    want = [j_win.window_document(d["sent_token_ids"], d["labels"], jw, i)
            for i, d in enumerate(docs)]
    got = [windowing.window_document(d["sent_token_ids"], d["labels"], tw, i)
           for i, d in enumerate(docs)]
    _assert_same(got, want, "windows")
    flat = lambda ws: [w for doc in ws for w in doc]
    _assert_same(windowing.stack_windows(flat(got)), j_win.stack_windows(flat(want)), "stack")
    for level in ("eop_matrix", "eop_list", "eot_list"):
        task = dict(cl_anchor_level=level, cl_loss_weight=0.5, do_tssp=True, do_da_ts=True)
        want_b = list(j_feat.batches_from_docs(docs, jw, jc.TopicSegConfig(**task), 4,
                                               np.random.default_rng(3), drop_last=False))
        got_b = list(featurization.batches_from_docs(docs, tw, tc.TopicSegConfig(**task), 4,
                                                     np.random.default_rng(3), drop_last=False))
        _assert_same(got_b, want_b, level)
    stacked = j_win.stack_windows(flat(want))
    rng = np.random.default_rng(5)
    token = rng.normal(size=stacked["labels"].shape + (2,)).astype(np.float32)
    gathered = rng.normal(size=stacked["sent_labels"].shape + (2,)).astype(np.float32)
    args = (stacked["example_id"], stacked["labels"], token, len(docs))
    _assert_same(windowing.aggregate_window_predictions(*args),
                 j_win.aggregate_window_predictions(*args), "aggregate")
    args = (stacked["example_id"], stacked["sent_labels"], gathered, len(docs))
    _assert_same(windowing.aggregate_gathered_predictions(*args),
                 j_win.aggregate_gathered_predictions(*args), "aggregate_gathered")


def test_segmentation_metrics_match_jax():
    from spokennlp_tpu.eval import seg_metrics as jm
    from spokennlp_tpu_torch.eval import seg_metrics as tm

    rng = np.random.default_rng(1)
    refs = [rng.integers(0, 2, size=rng.integers(3, 40)).tolist() for _ in range(12)]
    preds = [(np.asarray(r) ^ (rng.random(len(r)) < 0.2)).astype(int).tolist() for r in refs]
    assert tm.boundary_prf(preds, refs) == jm.boundary_prf(preds, refs)
    assert tm.compute_window_metric(preds, refs) == jm.compute_window_metric(preds, refs)
    scores = [rng.normal(size=(len(r), 2)).astype(np.float32) for r in refs]
    for kw in ({"threshold": 0.5}, {"topk": 3}, {"threshold": 0.5, "f1_at_k": 2}, {}):
        assert tm.compute_example_level_metric(scores, refs, **kw) == \
            jm.compute_example_level_metric(scores, refs, **kw), kw


def test_tokenizer_and_cli_flags_match_jax(tmp_path):
    from spokennlp_tpu.cli import common as jcommon
    from spokennlp_tpu.utils.tokenization import FullTokenizer as JaxTokenizer
    from spokennlp_tpu_torch.cli import common as tcommon
    from spokennlp_tpu_torch.utils.tokenization import FullTokenizer

    vocab = tmp_path / "vocab.txt"
    vocab.write_text("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "hello", "world",
                                "##s", "na", "##ive", ",", "!", "中", "文", "un", "##aff"]))
    text = "Hello, worlds! naive UNAFFable 中文 \t x"
    assert FullTokenizer.from_vocab_file(str(vocab)).encode(text) == \
        JaxTokenizer.from_vocab_file(str(vocab)).encode(text)

    def parse(common, argv):
        p = argparse.ArgumentParser()
        common.add_model_args(p)
        common.add_data_args(p)
        common.add_training_args(p)
        return p.parse_args(argv)

    argv = ["--output_dir", str(tmp_path / "o"), "--vocab_file", str(vocab), "--do_da_ts",
            "--cl_loss_weight", "0.5", "--warmup_ratio", "0.1", "--dtype", "bfloat16"]
    ja, ta = parse(jcommon, argv), parse(tcommon, argv)
    assert vars(ja) == vars(ta)
    (_, jspecial), (_, tspecial) = jcommon.resolve_tokenizer(ja), tcommon.resolve_tokenizer(ta)
    assert jspecial == tspecial
    for j, t in zip(jcommon.build_configs(ja, jspecial), tcommon.build_configs(ta, tspecial)):
        assert dataclasses.asdict(j) == dataclasses.asdict(t)


def _mug_submissions(rng, meetings):
    """One submission of each track for the meetings, from noisy labels."""
    keys = [m["meeting_key"] for m in meetings]
    n = [len(m["sentences"]) for m in meetings]
    pick = lambda k: sorted(set(rng.integers(1, k + 1, size=3).tolist()))
    topics = [[{"id": t["id"], "key_sentence": pick(k), "title": t["candidate"][0]["title"]}
               for t in m["topic_segment_ids"]] for m, k in zip(meetings, n)]
    return {
        "topic_segmentation": [{"meeting_key": mk, "topic_segment_ids": [{"id": i}
                                                                        for i in pick(k)]}
                               for mk, k in zip(keys, n)],
        "extractive_summarization": [
            {"meeting_key": mk, "topic_segment_ids": t, "key_sentence": pick(k)}
            for mk, t, k in zip(keys, topics, n)],
        "topic_title_generation": [{"meeting_key": mk, "topic_segment_ids": t}
                                   for mk, t in zip(keys, topics)],
        "keyphrase_extraction": [{"meeting_key": mk, "key_word": ["预算", "方案讨论", "x"]}
                                 for mk in keys],
        "action_item_detection": [{"meeting_key": mk, "action_ids": [{"id": i}
                                                                    for i in pick(k)]}
                                  for mk, k in zip(keys, n)],
    }


def test_mug_host_copies_match_jax(tmp_path):
    """The MUG slice's host copies: the data parsers and submission
    functions, the EOS windowing and the ES featuriser, rouge, and the
    challenge evaluator (its five tracks and run_mug_evaluate) give what the
    JAX package's modules give."""
    from spokennlp_tpu import configs as jc
    from spokennlp_tpu.cli import run_mug_evaluate as j_cli
    from spokennlp_tpu.eval import rouge as j_rouge
    from spokennlp_tpu.projects.mug import data as j_data
    from spokennlp_tpu.projects.mug import evaluate as j_eval
    from spokennlp_tpu.projects.mug import extractive_summarization as j_es
    from spokennlp_tpu.projects.mug import topic_segmentation as j_ts
    from spokennlp_tpu_torch import configs as tc
    from spokennlp_tpu_torch.cli import run_mug_evaluate as t_cli
    from spokennlp_tpu_torch.eval import rouge
    from spokennlp_tpu_torch.projects.mug import data, evaluate
    from spokennlp_tpu_torch.projects.mug import extractive_summarization as es
    from spokennlp_tpu_torch.projects.mug import topic_segmentation as ts
    from test_torch_mug import write_mug_corpus

    write_mug_corpus(tmp_path, n_meetings=4, n_sent=40, seed=3)
    meetings = data.read_jsonl(str(tmp_path / "dev.jsonl"))
    _assert_same(meetings, j_data.read_jsonl(str(tmp_path / "dev.jsonl")), "read_jsonl")
    tok = lambda s: [1000 + ord(c) % 500 for c in s] or [1000]
    kw = dict(max_seq_length=48, cls_token_id=2, pad_token_id=0, bos_token_id=1)
    jw, tw = jc.WindowingConfig(**kw), tc.WindowingConfig(**kw)
    for m in meetings:
        for fn in ("parse_topic_segmentation", "parse_title_generation", "parse_action_items",
                   "parse_keyphrases"):
            _assert_same(getattr(data, fn)(m), getattr(j_data, fn)(m), fn)
        for level in ("topic", "doc"):
            for strategy in ("single", "union", "major_vote", "pool"):
                _assert_same(data.parse_extractive_summarization(m, level, strategy),
                             j_data.parse_extractive_summarization(m, level, strategy),
                             f"es {level} {strategy}")
        parsed = data.parse_topic_segmentation(m)
        sents = [tok(s) for s in parsed["sentences"]]
        paragraphs = [1 + i // 3 for i in range(len(sents))]
        for par in (None, paragraphs):
            got = ts.window_document_eos(sents, parsed["labels"], tw, 3, 7, paragraph_ids=par)
            want = j_ts.window_document_eos(sents, parsed["labels"], jw, 3, 7, paragraph_ids=par)
            _assert_same(got, want, "windows")
            _assert_same(ts.stack_eos_windows(got), j_ts.stack_eos_windows(want), "stack")
    for level, strategy in (("topic", "single"), ("doc", "union"), ("topic", "pool")):
        _assert_same(es.featurize_es_examples(meetings, tok, tw, 3, level, strategy),
                     j_es.featurize_es_examples(meetings, tok, jw, 3, level, strategy), "es")

    rng = np.random.default_rng(4)
    words = [f"w{i}" for i in range(30)]
    text = lambda: " ".join(rng.choice(words, size=int(rng.integers(1, 12))))
    hyps, refs = [text() for _ in range(6)], [text() for _ in range(6)]
    for avg in (True, False):
        assert rouge.rouge_scores(hyps, refs, avg) == j_rouge.rouge_scores(hyps, refs, avg)
    multi = [[text() for _ in range(3)] for _ in hyps]
    assert rouge.multi_reference_rouge(hyps, multi) == j_rouge.multi_reference_rouge(hyps, multi)

    subs = _mug_submissions(rng, meetings)
    keys = [m["meeting_key"] for m in meetings]
    _assert_same(data.topic_segmentation_submission(keys, [[1, 5], [2]] * 2),
                 j_data.topic_segmentation_submission(keys, [[1, 5], [2]] * 2), "ts sub")
    for task, sub in subs.items():
        assert evaluate.TRACK_EVALUATORS[task](meetings, sub) == \
            j_eval.TRACK_EVALUATORS[task](meetings, sub), task
        data.write_jsonl(str(tmp_path / f"{task}.jsonl"), sub)
        argv = ["--task", task, "--label_file", str(tmp_path / "dev.jsonl"), "--pred_file",
                str(tmp_path / f"{task}.jsonl")]
        assert t_cli.main(argv) == j_cli.main(argv), task


def test_analysis_matches_jax(tmp_path):
    """eval/analysis.py: ensembling, the sentence-level re-mapping, run
    statistics, the p-value, corpus statistics, model tags, the result
    one-liner and the plot, against the JAX package's module."""
    from spokennlp_tpu.eval import analysis as ja
    from spokennlp_tpu_torch.eval import analysis as ta

    rng = np.random.default_rng(7)
    for x in (-30.0, -0.5, 0.0, 2.0, 40.0):
        assert ta.stable_sigmoid(x) == ja.stable_sigmoid(x)
    labels = [rng.integers(0, 2, size=n).tolist() for n in (5, 9, 3)]
    logits = [rng.normal(size=(len(l), 2)).astype(np.float32) for l in labels]
    sims = [rng.normal(size=len(l)).tolist() for l in labels]
    for kw in ({}, {"sim_temp": 2.0, "threshold": 0.4}):
        assert ta.ensemble_scores(logits, sims, labels, **kw) == \
            ja.ensemble_scores(logits, sims, labels, **kw)
    sent = [[-100, 0, -100, 1, 0], [0, -100, -100, 1]]
    para_labels = [[0, 1, 0], [0, 1]]
    para_preds = [[1, 1, 0], [0, 0]]
    assert ta.sent_level_metric_from_para_level(para_preds, para_labels, sent) == \
        ja.sent_level_metric_from_para_level(para_preds, para_labels, sent)
    runs = rng.normal(size=(3, 4)).tolist()
    assert ta.compute_avg_std(runs, list("abcd")) == ja.compute_avg_std(runs, list("abcd"))
    assert ta.compute_p_value(runs[0], runs[1]) == ja.compute_p_value(runs[0], runs[1])
    examples = [{"sentences": ["a", "b", "c"], "labels": [0, 1, -100]},
                {"sentences": ["d"], "labels": ["1"]}]
    assert ta.data_statistics(examples) == ja.data_statistics(examples)
    for name in ("allenai/longformer-base-4096", "google/bigbird-roberta-base",
                 "electra-large", "bert-base-uncased"):
        assert ta.abridge_model_name(name) == ja.abridge_model_name(name)
    with pytest.raises(ValueError):
        ta.abridge_model_name("gpt2")
    prefix = "threshold_0.5_example_level"
    res = {f"{prefix}_{k}": float(v) for k, v in zip(("precision", "recall", "f1", "pk", "wd"),
                                                      rng.random(5))}
    outs = []
    for side, mod in (("j", ja), ("t", ta)):
        (tmp_path / side).mkdir()
        path = tmp_path / side / "predict_results.json"
        path.write_text(json.dumps(res))
        outs.append((mod.convert_res_format(str(path), 0.5),
                     (tmp_path / side / "predict_results_str_metric.txt").read_text()))
    assert outs[0] == outs[1]
    pytest.importorskip("matplotlib")
    out = ta.plot_metric_curves([1, 2, 3], {"ours": [0.1, 0.2, 0.3],
                                            "base": ([0.1, 0.1, 0.2], {"linestyle": "--"})},
                                str(tmp_path / "curve.png"))
    assert os.path.getsize(out) > 0


def test_track_3_4_and_aid_host_copies_match_jax(tmp_path):
    """The host copies of this slice: data/ami.py (each parser and the whole
    corpus build), run_aid's ami_rows_to_meetings, projects/swab.py and the
    keyphrase helpers (BIO tags, spans, ranked phrases) give what the JAX
    package's modules give."""
    from spokennlp_tpu.cli import run_aid as j_aid
    from spokennlp_tpu.data import ami as j_ami
    from spokennlp_tpu.projects import swab as j_swab
    from spokennlp_tpu.projects.mug import keyphrase as j_kp
    from spokennlp_tpu_torch.cli import run_aid as t_aid
    from spokennlp_tpu_torch.data import ami as t_ami
    from spokennlp_tpu_torch.projects import swab as t_swab
    from spokennlp_tpu_torch.projects.mug import keyphrase as t_kp
    from test_torch_aid import ami_tree

    raw = Path(ami_tree(tmp_path / "ami"))
    meet = "ES2002a"
    for fn, path in (("parse_abstractive", raw / "abstractive" / f"{meet}.abssumm.xml"),
                     ("parse_extractive", raw / "extractive" / f"{meet}.summlink.xml"),
                     ("parse_da_types", raw / "ontologies" / "da-types.xml"),
                     ("parse_words", raw / "words" / f"{meet}.A.words.xml"),
                     ("parse_dialogue_acts", raw / "dialogueActs" / f"{meet}.A.dialog-act.xml")):
        _assert_same(getattr(t_ami, fn)(str(path)), getattr(j_ami, fn)(str(path)), fn)
    for name in ("ES2003d", "TS3007b", "XX9999", "IS1000a"):
        assert t_ami.which_split(name) == j_ami.which_split(name)
    kw = dict(num_left=1, num_right=3, num_global=1, seed=7)
    got = t_ami.process_ami_corpus(str(raw), str(tmp_path / "t"), **kw)
    want = j_ami.process_ami_corpus(str(raw), str(tmp_path / "j"), **kw)
    _assert_same(got, want, "ami splits")
    for split in ("train", "dev", "test"):
        assert (tmp_path / "t" / f"{split}.txt").read_text() == \
            (tmp_path / "j" / f"{split}.txt").read_text()
        _assert_same(t_aid.ami_rows_to_meetings(got[split]),
                     j_aid.ami_rows_to_meetings(want[split]), split)

    rng = np.random.default_rng(8)
    words = ["预算", "方案", "讨论", "设计", "we", "should", "order", "chips", "."]
    docs = []
    for i in range(3):
        sents = [{"id": j + 1, "s": " ".join(rng.choice(words, size=int(rng.integers(2, 7)))),
                  "s_gt": " ".join(rng.choice(words, size=3))} for j in range(9)]
        docs.append({"meeting_key": f"d{i}", "sentences": sents, "paragraph_segment_ids": [
            {"id": e, "target": " ".join(rng.choice(words, size=4))} for e in (3, 7, 9)]})
    (tmp_path / "swab.json").write_text(json.dumps(docs, ensure_ascii=False))
    (tmp_path / "swab.jsonl").write_text("\n".join(json.dumps(d) for d in docs))
    for name in ("swab.json", "swab.jsonl"):
        _assert_same(t_swab.load_swab(str(tmp_path / name)),
                     j_swab.load_swab(str(tmp_path / name)), name)
    pairs = []
    for d in docs:
        for gt in (False, True):
            got_p, want_p = t_swab.paragraph_pairs(d, gt), j_swab.paragraph_pairs(d, gt)
            _assert_same(got_p, want_p, "pairs")
            pairs += got_p
    hyps = [p["source"] for p in pairs]
    refs = [p["target"] for p in pairs]
    assert t_swab.evaluate_cos2w(hyps, refs) == j_swab.evaluate_cos2w(hyps, refs)

    for _ in range(20):
        tokens = list(rng.choice(list("abcab"), size=int(rng.integers(0, 12))))
        kps = [list(rng.choice(list("abc"), size=int(rng.integers(0, 3)))) for _ in range(3)]
        tags = t_kp.bio_tags_from_keyphrases(tokens, kps)
        assert tags == j_kp.bio_tags_from_keyphrases(tokens, kps)
        noisy = rng.integers(0, 3, size=len(tokens)).tolist()
        cut = int(rng.integers(0, len(tokens) + 1))  # a valid prefix, then padding
        mask = [1] * cut + [0] * (len(tokens) - cut)
        for t in (tags, noisy):
            assert t_kp.spans_from_bio(t, mask) == j_kp.spans_from_bio(t, mask)
    token_lists = [list("abcabc"), list("bca"), list("aab")]
    tag_lists = [[1, 2, 0, 1, 2, 2], [2, 1, 0], [1, 1, 2]]
    masks = [[1] * 6, [1, 1, 0], [1, 1, 1]]
    for k in (1, 2, 20):
        assert t_kp.extract_keyphrases(token_lists, tag_lists, masks, k) == \
            j_kp.extract_keyphrases(token_lists, tag_lists, masks, k)


def _raw_corpora(root: Path) -> Path:
    """Small raw corpora in the reference's formats: WikiSection json for
    both subsets and splits, a wiki-727k folder, WikiElements files."""
    rng = np.random.default_rng(11)
    words = lambda n: " ".join(f"w{i}" for i in rng.integers(0, 50, size=n))
    raw = root / "raw"
    raw.mkdir()
    for subset in ("disease", "city"):
        for split in ("train", "validation", "test"):
            docs = []
            for _ in range(2):
                text, annotations = "", []
                for s in range(3):
                    sec = "\n".join(f"{words(4)}. {words(3)}! {words(5)}?"
                                     for _ in range(rng.integers(1, 3)))
                    annotations.append({"begin": len(text), "length": len(sec),
                                        "sectionLabel": f"{subset}.s{s}"})
                    text += sec + "\n"
                docs.append({"text": text, "annotations": annotations})
            (raw / f"wikisection_en_{subset}_{split}.json").write_text(json.dumps(docs))
    for mode in ("train", "dev", "test"):
        d = raw / "wiki727k" / mode / "sub"
        d.mkdir(parents=True)
        for i in range(2):
            lines = []
            for s in range(3):
                lines.append(f"========,{s},title{s}.")
                lines += [words(6) + "." for _ in range(rng.integers(1, 4))]
            (d / f"doc{i}").write_text("\n".join(lines) + "\n")
    el = raw / "elements"
    el.mkdir()
    seg, text = [], []
    for doc in range(3):
        for para in range(4):
            seg.append(f"d{doc},{para},topic{para // 2}")
            text.append(words(7))
    (el / "wikielements.segmenttitles").write_text("\n".join(seg) + "\n")
    (el / "wikielements.text").write_text("\n".join(text) + "\n")
    return raw


def test_corpus_converters_and_run_process_data_match_jax(tmp_path):
    """data/corpora.py's raw-corpus converters and cli/run_process_data.py
    write the same files as the JAX package's, for every wiki dataset and
    for AMI (an NXT tree built as tests/test_ami.py builds one)."""
    from spokennlp_tpu.cli import run_process_data as j_cli
    from spokennlp_tpu.data import corpora as jc
    from spokennlp_tpu_torch.cli import run_process_data as t_cli
    from spokennlp_tpu_torch.data import corpora as tc

    raw = _raw_corpora(tmp_path)
    section = str(raw / "wikisection_en_city_test.json")
    assert tc.convert_wikisection_file(section) == jc.convert_wikisection_file(section)
    one = next((raw / "wiki727k" / "dev").rglob("doc*"))
    assert tc.convert_choi_style_file(str(one)) == jc.convert_choi_style_file(str(one))
    assert tc.section_to_sentences("a b. c d!\n\ne f?") == \
        jc.section_to_sentences("a b. c d!\n\ne f?")
    for dataset, folder in (("wiki_section", raw), ("wiki727k", raw / "wiki727k"),
                            ("wiki50", raw / "wiki727k" / "test"),
                            ("wiki_elements", raw / "elements")):
        outs = {}
        for side, cli in (("j", j_cli), ("t", t_cli)):
            out = tmp_path / side / dataset / "out"
            cli.main(["--dataset", dataset, "--data_folder", str(folder),
                      "--out_folder", str(out)])
            outs[side] = {str(p.relative_to(tmp_path / side)): p.read_text()
                          for p in sorted((tmp_path / side / dataset).rglob("*.jsonl"))}
        assert outs["t"] == outs["j"] and outs["t"], dataset
    from test_torch_aid import ami_tree

    ami_raw = ami_tree(tmp_path / "ami_raw")
    outs = {}
    for side, cli in (("j", j_cli), ("t", t_cli)):
        out = tmp_path / side / "ami"
        cli.main(["--dataset", "ami", "--data_folder", ami_raw, "--out_folder", str(out),
                  "--ami_meetings_jsonl"])
        outs[side] = {p.name: p.read_text() for p in sorted(out.iterdir())}
    assert outs["t"] == outs["j"] and outs["t"]["train.txt"]


def test_ditto_and_sld_host_copies_match_jax(tmp_path):
    """The host copies of the Ditto and SLD slice give what the JAX
    package's give: eval/asr_metrics.py; the pipeline's manifests, wave
    reader, speed perturbation, run dedupe, labels, k-means tokens and BPE;
    SLD's packing, prompts, text extraction and run_sld's word vocabulary;
    the Ditto loaders (STS, SentEval STS, the seven transfer tasks, probing,
    relatedness in three formats), recipes and score encoding; WavLM's
    relative-position buckets."""
    import wave as wavemod

    from spokennlp_tpu.cli import run_sld as j_cli
    from spokennlp_tpu.eval import asr_metrics as j_asr
    from spokennlp_tpu.models import wavlm as j_wavlm
    from spokennlp_tpu.projects import ditto as j_ditto
    from spokennlp_tpu.projects import sld as j_sld
    from spokennlp_tpu.projects import sld_pipeline as j_pipe
    from spokennlp_tpu_torch.cli import run_sld as t_cli
    from spokennlp_tpu_torch.eval import asr_metrics as t_asr
    from spokennlp_tpu_torch.models import wavlm as t_wavlm
    from spokennlp_tpu_torch.projects import ditto as t_ditto
    from spokennlp_tpu_torch.projects import sld as t_sld
    from spokennlp_tpu_torch.projects import sld_pipeline as t_pipe

    rng = np.random.default_rng(9)
    words = ["go", "stop", "left", "", "中文", "naïve", "up"]
    refs = [" ".join(rng.choice(words, size=int(rng.integers(0, 8)))) for _ in range(12)]
    hyps = [" ".join(rng.choice(words, size=int(rng.integers(0, 8)))) for _ in range(12)]
    for fn in ("wer", "cer"):
        assert getattr(t_asr, fn)(hyps, refs) == getattr(j_asr, fn)(hyps, refs)
    assert t_asr.edit_distance("kitten", "sitting") == j_asr.edit_distance("kitten", "sitting")

    audio = tmp_path / "audio" / "sub"
    audio.mkdir(parents=True)
    for i, (width, ch) in enumerate(((2, 1), (4, 1), (2, 2))):
        pcm = rng.integers(-2**(8 * width - 2), 2**(8 * width - 2), size=400 * ch)
        with wavemod.open(str(audio / f"u{i}.wav"), "wb") as w:
            w.setnchannels(ch)
            w.setsampwidth(width)
            w.setframerate(16000)
            w.writeframes(pcm.astype(np.int16 if width == 2 else np.int32).tobytes())
    (audio / "skip.flac").write_text("")
    man_t = t_pipe.make_manifest(str(tmp_path / "audio"), ext="wav", valid_percent=0.4, seed=3)
    _assert_same(man_t, j_pipe.make_manifest(str(tmp_path / "audio"), ext="wav",
                                             valid_percent=0.4, seed=3), "manifest")
    tmap = {"sub/u0.wav": "by path", "u1": "by id"}
    for split in man_t:
        assert t_pipe.make_labels(man_t[split], tmap) == j_pipe.make_labels(man_t[split], tmap)
    for i in range(3):
        w = t_pipe.read_wav(str(audio / f"u{i}.wav"))
        _assert_same(w, j_pipe.read_wav(str(audio / f"u{i}.wav")), f"wav {i}")
        for factor in (0.9, 1.0, 1.1):
            _assert_same(t_pipe.speed_perturb(w, factor), j_pipe.speed_perturb(w, factor))
    toks = rng.integers(0, 5, size=200).tolist()
    assert t_pipe.dedupe_runs(toks) == j_pipe.dedupe_runs(toks)

    class KM:
        cluster_centers_ = rng.normal(size=(7, 6)).astype(np.float32)

    feats = rng.normal(size=(50, 6)).astype(np.float32)
    _assert_same(t_pipe.apply_kmeans(KM, feats), j_pipe.apply_kmeans(KM, feats), "kmeans")
    corpus = [" ".join(str(t) for t in rng.integers(0, 6, size=int(rng.integers(3, 20))))
              for _ in range(30)]
    merges = t_pipe.train_bpe(corpus, vocab_size=20)
    assert merges == j_pipe.train_bpe(corpus, vocab_size=20) and merges
    for line in corpus[:5]:
        assert t_pipe.bpe_encode(line.split(), merges) == j_pipe.bpe_encode(line.split(), merges)

    kw = dict(gpt_vocab_size=30, vocab_size_speech=12, block_size=24, max_text_length=6,
              eos_token_id=29)
    jc, tc = j_sld.SLDConfig(**kw), t_sld.SLDConfig(**kw)
    assert (tc.total_vocab, tc.speech_end_id, tc.text_end_id) == \
        (jc.total_vocab, jc.speech_end_id, jc.text_end_id)
    packed = []
    for n_sp, n_tx in ((5, 3), (30, 9), (0, 2), (4, 0)):
        sp, tx = rng.integers(0, 12, size=n_sp).tolist(), rng.integers(0, 29, size=n_tx).tolist()
        got, want = t_sld.pack_example(sp, tx, tc), j_sld.pack_example(sp, tx, jc)
        _assert_same(got, want, f"pack {n_sp} {n_tx}")
        if got is not None:
            packed.append(got["input_ids"])
    ids = np.stack(packed + [np.full(24, 5, np.int32)])
    _assert_same(t_sld.build_prompts(ids, tc), j_sld.build_prompts(ids, jc), "prompts")
    assert t_sld.extract_text_tokens(ids, tc) == j_sld.extract_text_tokens(ids, jc)
    rows = [{"text": r} for r in refs]
    (te, td, tn), (je, jd_, jn) = t_cli._word_vocab([rows]), j_cli._word_vocab([rows])
    assert tn == jn and [te(r) for r in refs] == [je(r) for r in refs]
    assert td([0, 1, 99]) == jd_([0, 1, 99])

    for L, nb, md in ((12, 32, 50), (300, 320, 800)):
        _assert_same(t_wavlm.relative_position_buckets(L, nb, md),
                     j_wavlm.relative_position_buckets(L, nb, md), f"buckets {L}")

    d = tmp_path / "senteval"
    d.mkdir()
    sents = [" ".join(rng.choice(words[:3] + ["x", "y"], size=3)) for _ in range(6)]
    (d / "sts.tsv").write_text("\n".join(f"{a}\t{b}\t{i}.5" for i, (a, b) in
                                         enumerate(zip(sents, sents[::-1]))) + "\nbad line\n")
    _assert_same(t_ditto.load_sts_tsv(str(d / "sts.tsv")), j_ditto.load_sts_tsv(str(d / "sts.tsv")))
    for ss in ("a", "b"):
        (d / f"STS.input.{ss}.txt").write_text("\n".join(f"{a}\t{b}" for a, b in
                                                        zip(sents, sents[1:])))
        (d / f"STS.gs.{ss}.txt").write_text("\n".join(["1.0", "", "3.5", "4", "0"]))
    _assert_same(t_ditto.load_senteval_sts(str(d), ["a", "b"], "x"),
                 j_ditto.load_senteval_sts(str(d), ["a", "b"], "x"))
    for name in ("rt-polarity.pos", "rt-polarity.neg", "custrev.pos", "custrev.neg",
                 "subj.subjective", "subj.objective", "mpqa.pos", "mpqa.neg"):
        (d / name).write_text("\n".join(sents[:3]) + "\n\n")
    (d / "sentiment-train").write_text("1\tgood one\n0\tbad one\nnolabel")
    (d / "sentiment-test").write_text("1\tfine\n")
    (d / "train_5500.label").write_text("DESC:def what is x\nNUM:count how many\nHUM:ind who\n")
    (d / "TREC_10.label").write_text("NUM:date when\nDESC:def what\n")
    header = "Quality\t#1 ID\t#2 ID\t#1 String\t#2 String\n"
    (d / "msr_paraphrase_train.txt").write_text(header + "1\t1\t2\ta b\tc d\n0\t3\t4\te\tf\n")
    (d / "msr_paraphrase_test.txt").write_text(header + "1\t5\t6\tg\th\nshort\n")
    for task in ("MR", "CR", "SUBJ", "MPQA", "SST2", "TREC", "MRPC"):
        _assert_same(t_ditto.load_senteval_classification(str(d), task),
                     j_ditto.load_senteval_classification(str(d), task), task)
    (d / "probe.txt").write_text("tr\tB\tone two\ntr\tA\tthree\nva\tA\tfour\n"
                                 "te\tB\tfive six\nxx\tA\tskip\n")
    _assert_same(t_ditto.load_senteval_probing(str(d / "probe.txt")),
                 j_ditto.load_senteval_probing(str(d / "probe.txt")), "probing")
    (d / "SICK_train.txt").write_text("pair\tA\tB\tscore\n1\ta\tb\t3.2\n")
    (d / "SICK_test_annotated.txt").write_text("pair\tA\tB\tscore\n2\tc\td\t4.5\n")
    (d / "sts-train.csv").write_text("g\tf\ty\t1\t2.5\tone\ttwo\nshort\trow\n")
    (d / "sts-test.csv").write_text("g\tf\ty\t2\t4.0\tthree\tfour\n")
    (d / "train.tsv").write_text("2.0\ta\tb\n")
    (d / "test.tsv").write_text("5.0\tc\td\n")
    for fmt in ("sick", "stsb", "tsv"):
        _assert_same(t_ditto.load_relatedness_files(str(d), fmt),
                     j_ditto.load_relatedness_files(str(d), fmt), fmt)
    scores = np.array([1.0, 2.5, 4.99, 5.0, 0.3, 7.0], np.float32)
    _assert_same(t_ditto._score_distribution(scores), j_ditto._score_distribution(scores))
    for name in ("bert-base-uncased", "my-roberta-base-ft", "SBERT", "electra", "other"):
        assert t_ditto.recipe_for(name) == j_ditto.recipe_for(name)
    a, b = rng.normal(size=(9, 5)), rng.normal(size=(9, 5))
    _assert_same(t_ditto.cosine_scores(a, b), j_ditto.cosine_scores(a, b))
    assert t_ditto.spearman(a[:, 0], b[:, 0]) == j_ditto.spearman(a[:, 0], b[:, 0])


# the Longformer, BigBird, MUG, Track 3-4, AID, Ditto, SLD and MMVTS slices'
# modules, which the package walk must reach
LONGFORMER_MODULES = [f"spokennlp_tpu_torch.{m}" for m in (
    "ops.sliding_attention", "ops.cuda.sliding_block", "ops.cuda.train_sliding", "eval.analysis",
    "ops.bigbird_attention", "ops.cuda.bigbird_block", "ops.cuda.train_bigbird",
    "models.checkpoint_io", "models.ponet", "ops.cuda.ponet_block", "projects.mug.data",
    "projects.mug.topic_segmentation", "projects.mug.extractive_summarization",
    "projects.mug.evaluate", "eval.rouge", "cli.run_mug", "cli.run_mug_evaluate",
    "ops.cuda.attention_models", "eval.packed_inference", "eval.streaming", "models.hf_convert",
    "models.hf_export", "cli.hf_checkpoint", "cli.run_process_data", "ops.crf",
    "projects.mug.keyphrase", "projects.action_item", "data.ami", "cli.run_aid",
    "models.seq2seq", "models.palm", "cli.run_title_generation", "projects.swab",
    "eval.asr_metrics", "projects.senteval_classifier", "projects.ditto", "cli.run_ditto",
    "models.gpt2", "models.generation", "projects.sld", "cli.run_sld", "models.wavlm",
    "projects.sld_pipeline", "cli.run_sld_pipeline", "eval.video_metrics",
    "objectives.mmvts_losses", "models.multimodal", "models.clip_vit", "projects.mmvts",
    "cli.run_finetune_multimodal", "dryrun")]


# the card scripts: chip_smoke.py and every measuring script in turns
CARD_SCRIPTS = ["chip_smoke"] + sorted(p.stem for p in REPO.glob("*_turns.py"))


@pytest.mark.parametrize("target", ["package"] + CARD_SCRIPTS)
def test_port_imports_nothing_of_the_jax_package(target):
    """A fresh interpreter imports every module of the port (or one of the
    card scripts: chip_smoke.py and each ``*_turns.py``) and checks that
    neither spokennlp_tpu nor jax was loaded."""
    code = """
import importlib, pkgutil, sys
import spokennlp_tpu_torch
names = [sys.argv[1]] if sys.argv[1] != "package" else [
    m.name for m in pkgutil.walk_packages(spokennlp_tpu_torch.__path__, "spokennlp_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "flax", "optax"))
             or m == "spokennlp_tpu" or m.startswith("spokennlp_tpu."))
print(len(names), bad)
assert not bad, bad
missing = [m for m in LONGFORMER_MODULES if sys.argv[1] == "package" and m not in sys.modules]
assert not missing, missing
"""
    code = f"LONGFORMER_MODULES = {LONGFORMER_MODULES!r}\n" + code
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run([sys.executable, "-c", code, target], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n, _ = proc.stdout.split(" ", 1)
    assert int(n) >= (40 if target == "package" else 1)
