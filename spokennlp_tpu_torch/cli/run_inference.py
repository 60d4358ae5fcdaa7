"""Topic-segmentation inference CLI on PyTorch.

Counterpart of ``spokennlp_tpu/cli/run_inference.py``: the same flags and
output files (``predict_*.txt`` with one JSON line per document and
``predict_*_results.json`` with the metrics), plus ``--device``. Weights
come from ``--model_name_or_path`` (a native checkpoint directory or an HF
one of type bert, longformer, electra or big_bird; ``cli/common.py``
``maybe_load_pretrained``), else from ``--seed``. ``--ts_score_predictor
cos`` scores sentences by the sigmoid of adjacent cosine similarities.
Under ``torchrun --nproc_per_node=N`` (or with ``--jax_distributed``) each
process scores its block of the windows on its card and every process gets
all the scores (eval/inference.py); rank 0 writes the files.

    python -m spokennlp_tpu_torch.cli.run_inference --data_dir <wiki_section dir> \
        --output_dir out --dtype bfloat16 --per_device_eval_batch_size 32 \
        [--model_name_or_path <checkpoint dir>]
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from spokennlp_tpu_torch.cli import common
from spokennlp_tpu_torch.parallel import dist as dist_lib
from spokennlp_tpu_torch.parallel import mesh as mesh_lib


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    common.add_model_args(p)
    common.add_data_args(p)
    common.add_training_args(p)
    p.add_argument("--device", default="cuda",
                   help="torch device to run on; cuda raises when no card is present")
    return p


def resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA device is available")
    return device


def build_model(args, enc_cfg, task_cfg, params=None):
    """The topic-segmentation model on ``args.device`` with weights drawn
    from ``torch.Generator().manual_seed(args.seed)``, then ``params`` (a tree
    from ``common.maybe_load_pretrained``) put over them."""
    from spokennlp_tpu_torch.models.topic_seg import TopicSegModel

    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    generator = torch.Generator().manual_seed(args.seed)
    model = TopicSegModel(enc_cfg, task_cfg, dtype=dtype, generator=generator)
    if params is not None:
        common.load_pretrained_into(model, params)
    return model.to(resolve_device(args.device)).eval()


def configs_and_weights(args, special):
    """(enc_cfg, task_cfg, wcfg, tcfg, params): the flags' configs, with the
    checkpoint's encoder config and its tree, its word embeddings grown to
    the tokenizer's vocabulary, where ``--model_name_or_path`` names one
    (params None otherwise)."""
    enc_cfg, task_cfg, wcfg, tcfg = common.build_configs(args, special)
    params = None
    pretrained = common.maybe_load_pretrained(args, enc_cfg)
    if pretrained is not None:
        enc_cfg, params = pretrained
        params, enc_cfg = common.resize_word_embeddings(params, enc_cfg, special["vocab_size"],
                                                        seed=tcfg.seed)
    return enc_cfg, task_cfg, wcfg, tcfg, params


def main(argv=None):
    args = make_parser().parse_args(argv)
    resolve_device(args.device)
    mesh_lib.check_model_parallel(args.model_parallel_size)
    joined = common.maybe_init_distributed(args)
    try:
        return predict(args)
    finally:
        if joined:
            dist_lib.destroy()


def predict(args):
    """One prediction run of the parsed flags; rank 0 writes the files."""
    from spokennlp_tpu_torch.eval.inference import run_topic_seg_inference

    os.makedirs(args.output_dir, exist_ok=True)

    tokenize_fn, special = common.resolve_tokenizer(args)
    enc_cfg, task_cfg, wcfg, _, params = configs_and_weights(args, special)
    model = build_model(args, enc_cfg, task_cfg, params)

    docs = common.load_docs(args, tokenize_fn)
    test_docs = docs.get("test") or docs.get("validation") or []
    if not test_docs:
        raise ValueError("no test/validation split found")

    t0 = time.perf_counter()
    out = run_topic_seg_inference(
        model,
        test_docs,
        wcfg,
        batch_size=args.per_device_eval_batch_size,
        threshold=args.threshold,
        topk=args.topk,
        f1_at_k=args.f1_at_k,
        ts_score_predictor=args.ts_score_predictor,
        cos_temp=args.ts_score_predictor_cos_temp,
    )
    out["predict_time_s"] = time.perf_counter() - t0
    print("predict_time(s): ", out["predict_time_s"])

    if dist_lib.rank() != 0:
        return out
    metric_name = "_".join(
        ["predict", args.test_data_name, f"max_seq{args.max_seq_length}",
         f"ts_score_{args.ts_score_predictor}"]
    )
    with open(os.path.join(args.output_dir, metric_name + ".txt"), "w") as f:
        for doc, res in zip(test_docs, out["per_doc"]):
            if not len(res["labels"]):
                preds = []
            elif res["scores"].ndim == 2:
                preds = np.argmax(res["scores"], -1).tolist()
            else:  # cos predictor: sigmoid-cos > 0.5 -> similar -> O (1)
                preds = (res["scores"] > 0.5).astype(np.int32).tolist()
            f.write(
                json.dumps(
                    {
                        "sentences": doc.get("sentences", []),
                        "labels": ["B-EOP" if l == 0 else "O" for l in res["labels"]],
                        "int_labels": [int(v) for v in res["labels"]],
                        "predictions": ["B-EOP" if p == 0 else "O" for p in preds],
                        "predict_logits": res["scores"].tolist(),
                    },
                    ensure_ascii=False,
                )
                + "\n"
            )
    with open(os.path.join(args.output_dir, metric_name + "_results.json"), "w") as f:
        json.dump(out["metrics"], f, indent=2, default=float)
    print(json.dumps(out["metrics"], indent=2, default=float))
    return out


if __name__ == "__main__":
    main()
