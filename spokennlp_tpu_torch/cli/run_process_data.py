"""Corpus preprocessing CLI: raw corpora -> unified jsonl.

Counterpart of ``spokennlp_tpu/cli/run_process_data.py`` (the reference's
preprocess_data.py:227-264), with the same flags and files: the wiki
datasets, and AMI (``--dataset ami``: the NXT XML annotations ->
train/dev/test.txt TSVs for action-item detection, ``data/ami.py``; with
``--ami_meetings_jsonl`` also ``<split>_meetings.jsonl`` for
``cli/run_aid.py``):

    python -m spokennlp_tpu_torch.cli.run_process_data --dataset wiki_section \\
        --data_folder <raw dir> --out_folder <dir>/wiki_section
    python -m spokennlp_tpu_torch.cli.run_process_data --dataset ami \\
        --data_folder <AMI NXT dir> --out_folder <dir>/ami --ami_meetings_jsonl
"""

from __future__ import annotations

import argparse
import json
import os


def _write_jsonl(path: str, examples):
    with open(path, "w") as f:
        for ex in examples:
            f.write(json.dumps(ex) + "\n")


def main(argv=None):
    from spokennlp_tpu_torch.data import corpora

    p = argparse.ArgumentParser()
    p.add_argument("--dataset", required=True,
                   choices=["wiki_section", "wiki727k", "wiki50", "wiki_elements", "ami"])
    p.add_argument("--data_folder", required=True)
    p.add_argument("--out_folder", required=True)
    p.add_argument("--ami_similarity_file", default=None,
                   help="similarity json for AMI global context")
    p.add_argument("--ami_num_context", type=int, default=2)
    p.add_argument("--ami_meetings_jsonl", action="store_true",
                   help="also write meetings jsonl for cli/run_aid")
    args = p.parse_args(argv)
    os.makedirs(args.out_folder, exist_ok=True)

    if args.dataset == "wiki_section":
        subsets = {"disease": {}, "city": {}}
        for subset in subsets:
            sub_out = os.path.join(os.path.dirname(args.out_folder.rstrip("/")),
                                   f"wiki_section_{subset}")
            os.makedirs(sub_out, exist_ok=True)
            for mode, split in (("train", "train"), ("dev", "validation"), ("test", "test")):
                in_file = os.path.join(args.data_folder, f"wikisection_en_{subset}_{split}.json")
                examples = corpora.convert_wikisection_file(in_file)
                subsets[subset][mode] = examples
                _write_jsonl(os.path.join(sub_out, f"{mode}.jsonl"), examples)
        # merged disease + city
        for mode in ("train", "dev", "test"):
            _write_jsonl(os.path.join(args.out_folder, f"{mode}.jsonl"),
                         subsets["disease"][mode] + subsets["city"][mode])
    elif args.dataset == "wiki727k":
        for mode in ("test", "dev", "train"):
            corpora.convert_wiki_folder(os.path.join(args.data_folder, mode),
                                        os.path.join(args.out_folder, f"{mode}.jsonl"))
    elif args.dataset == "wiki50":
        corpora.convert_wiki_folder(args.data_folder, os.path.join(args.out_folder, "test.jsonl"))
    elif args.dataset == "wiki_elements":
        corpora.convert_wiki_elements(
            os.path.join(args.data_folder, "wikielements.text"),
            os.path.join(args.data_folder, "wikielements.segmenttitles"),
            os.path.join(args.out_folder, "test.jsonl"),
        )
    elif args.dataset == "ami":
        # AMI NXT XML annotations -> AID train/dev/test TSVs (data/ami.py;
        # reference: action-item-detection/data_script/ami_process.py)
        from spokennlp_tpu_torch.data import ami

        splits = ami.process_ami_corpus(
            args.data_folder,
            args.out_folder,
            num_left=args.ami_num_context,
            num_right=args.ami_num_context,
            similarity_file=args.ami_similarity_file,
        )
        if args.ami_meetings_jsonl:
            from spokennlp_tpu_torch.cli.run_aid import ami_rows_to_meetings

            for split, rows in splits.items():
                with open(os.path.join(args.out_folder, f"{split}_meetings.jsonl"), "w") as f:
                    for m in ami_rows_to_meetings(rows):
                        f.write(json.dumps(m) + "\n")
    print("done")


if __name__ == "__main__":
    main()
