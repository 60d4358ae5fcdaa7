"""Topic-segmentation fine-tuning CLI on PyTorch.

Counterpart of ``spokennlp_tpu/cli/run_finetune.py``: the same flags, plus
``--device`` (``cuda`` by default; it raises when no card is present) and
``--logging_steps`` (the train-metrics cadence, 50 as in the JAX trainer).
It writes ``metrics.jsonl`` (train, eval and train_end events),
``all_results.json`` (train, ``eval_*`` and ``predict_*`` results) and the
trained model in ``final_model/``: ``params.msgpack`` and ``config.json``
(the native checkpoint, which ``--model_name_or_path`` and the JAX package
read) and ``model.pt`` (the ``state_dict``); with ``--save_hf_format`` also
``final_model_hf/`` (``pytorch_model.bin`` and an HF ``config.json``).
Weights start from ``--model_name_or_path`` (``run_inference``'s checkpoint
directories) or ``--seed``; ``--seeds`` with two or more seeds repeats the
run under ``<output_dir>/seed_<n>`` for each and writes the mean and
standard deviation of every numeric result to ``multi_seed_results.json``
(the reference's ``for seed in 42 59 88`` loop). ``--gradient_checkpointing``
recomputes every layer in the backward (``EncoderConfig.remat``, the same
gradients bit for bit); ``--report_to tensorboard`` writes the train and
eval scalars under ``<output_dir>/tensorboard``. Under ``torchrun
--nproc_per_node=N`` (or with ``--jax_distributed``) it trains data parallel,
one process a card (NCCL; gloo with ``--device cpu``): the global batch is
``--per_device_train_batch_size`` x N, and rank 0 writes every file.

    python -m spokennlp_tpu_torch.cli.run_finetune --data_dir <wiki_section dir> \
        --output_dir out --do_train --do_eval --do_predict --dtype bfloat16 \
        --cl_loss_weight 0.5 --cl_anchor_level eop_matrix --tssp_loss_weight 1.0 \
        --do_tssp --do_da_ts

The reference's Longformer recipe (window 512, 2048 tokens, batch 2 with 4
accumulation steps, eop_list CSSL) adds ``--attention_type sliding_window
--attention_window 512 --max_seq_length 2048 --per_device_train_batch_size 2
--gradient_accumulation_steps 4 --cl_anchor_level eop_list --seeds 42 59 88``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import torch

from spokennlp_tpu_torch.cli import common
from spokennlp_tpu_torch.cli.run_inference import build_model, configs_and_weights, resolve_device
from spokennlp_tpu_torch.models import checkpoint_io
from spokennlp_tpu_torch.parallel import dist as dist_lib
from spokennlp_tpu_torch.parallel import mesh as mesh_lib


def make_parser():
    p = argparse.ArgumentParser()
    common.add_model_args(p)
    common.add_data_args(p)
    common.add_training_args(p)
    p.add_argument("--device", default="cuda",
                   help="torch device to run on; cuda raises when no card is present")
    p.add_argument("--logging_steps", type=int, default=50,
                   help="log the train metrics every this many optimizer steps")
    p.add_argument("--seeds", type=int, nargs="+", default=None,
                   help="multi-seed repeats with mean/std aggregation (the reference's "
                   "`for seed in 42 59 88` loop, run_finetune.sh:50)")
    return p


def save_final_model(path: str, model: torch.nn.Module, enc_cfg):
    """The native checkpoint (``<path>/params.msgpack``, ``<path>/config.json``)
    and ``<path>/model.pt`` (the state_dict)."""
    checkpoint_io.save_checkpoint(path, checkpoint_io.params_from_state_dict(model.state_dict()),
                                  enc_cfg)
    torch.save(model.state_dict(), os.path.join(path, "model.pt"))


def main(argv=None):
    args = make_parser().parse_args(argv)
    joined = common.maybe_init_distributed(args)
    try:
        return run_seeds(args)
    finally:
        if joined:
            dist_lib.destroy()


def run_seeds(args):
    """``main_single`` once, or once a seed of ``--seeds`` with the mean and
    standard deviation of the results."""
    if args.seeds and len(args.seeds) > 1:
        from spokennlp_tpu_torch.eval.analysis import compute_avg_std

        per_seed, keys = [], None
        for seed in args.seeds:
            sub = argparse.Namespace(**vars(args))
            sub.seeds, sub.seed = None, seed
            sub.output_dir = os.path.join(args.output_dir, f"seed_{seed}")
            res = main_single(sub)
            keys = keys or sorted(k for k, v in res.items() if isinstance(v, (int, float)))
            per_seed.append([float(res.get(k, 0.0)) for k in keys])
        agg = compute_avg_std(per_seed, keys)
        if dist_lib.rank() == 0:
            os.makedirs(args.output_dir, exist_ok=True)
            with open(os.path.join(args.output_dir, "multi_seed_results.json"), "w") as f:
                json.dump(agg, f, indent=2)
            print(json.dumps(agg, indent=2))
        return agg
    return main_single(args)


def main_single(args):
    """One fine-tuning run of the parsed flags; returns its results."""
    from spokennlp_tpu_torch.eval.inference import run_topic_seg_inference
    from spokennlp_tpu_torch.train.trainer import TopicSegTrainer

    resolve_device(args.device)
    mesh_lib.check_model_parallel(args.model_parallel_size)
    is_main = dist_lib.rank() == 0
    os.makedirs(args.output_dir, exist_ok=True)

    tokenize_fn, special = common.resolve_tokenizer(args)
    enc_cfg, task_cfg, wcfg, tcfg, params = configs_and_weights(args, special)
    tcfg = dataclasses.replace(tcfg, log_every=args.logging_steps)
    model = build_model(args, enc_cfg, task_cfg, params)

    docs = common.load_docs(args, tokenize_fn)
    trainer = TopicSegTrainer(
        model,
        task_cfg,
        tcfg,
        wcfg,
        train_docs=docs.get("train", []),
        eval_docs=docs.get("validation"),
        metric_for_best=args.metric_for_best_model,
        log_path=os.path.join(args.output_dir, "metrics.jsonl"),
    )
    # an explicit --resume_from_checkpoint must resolve; otherwise resume
    # from the newest checkpoint under the output dir, if any
    if args.resume_from_checkpoint:
        if not trainer.restore_latest(args.resume_from_checkpoint):
            raise FileNotFoundError(
                f"--resume_from_checkpoint: no checkpoint under {args.resume_from_checkpoint}"
            )
        print("resumed from checkpoint")
    elif trainer.restore_latest():
        print("resumed from checkpoint")

    results = {}
    try:
        if args.do_train:
            results.update(trainer.train())
        if args.do_train and is_main:
            save_final_model(os.path.join(args.output_dir, "final_model"), model, enc_cfg)
            if args.save_hf_format:
                from spokennlp_tpu_torch.models import hf_export

                src = args.model_name_or_path
                hf_export.save_hf_checkpoint(
                    os.path.join(args.output_dir, "final_model_hf"),
                    checkpoint_io.params_from_state_dict(model.state_dict()), enc_cfg,
                    tokenizer_src=src if src and os.path.isdir(src) else None,
                )
        if args.do_eval:
            results.update({f"eval_{k}": v for k, v in trainer.evaluate().items()})
    finally:
        trainer.metrics_log.close()
    if args.do_predict and "test" in docs:
        out = run_topic_seg_inference(
            model,
            docs["test"],
            wcfg,
            batch_size=args.per_device_eval_batch_size,
            threshold=args.threshold,
            topk=args.topk,
            f1_at_k=args.f1_at_k,
            ts_score_predictor=args.ts_score_predictor,
            cos_temp=args.ts_score_predictor_cos_temp,
        )
        results.update({f"predict_{k}": v for k, v in out["metrics"].items()})

    if is_main:
        with open(os.path.join(args.output_dir, "all_results.json"), "w") as f:
            json.dump(results, f, indent=2, default=float)
        print(json.dumps(results, indent=2, default=float))
    dist_lib.barrier()
    return results


if __name__ == "__main__":
    main()
