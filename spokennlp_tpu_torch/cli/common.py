"""Shared CLI plumbing of the port: flag groups, tokenizer resolution,
configs and corpus loading.

The port's own copy of ``spokennlp_tpu/cli/common.py``'s flag groups,
``resolve_tokenizer``, ``build_configs`` and ``load_docs``, with the same
flags and defaults. ``resolve_tokenizer`` knows a ``--vocab_file`` and the
hash fallback but not a checkpoint directory's tokenizer (the CLIs refuse a
checkpoint directory before they get here). The fallback hashes words with
``zlib.crc32``, where the JAX package's uses the salted ``hash()``: the same
flags give the same ids in every interpreter, and other ids than JAX's.
"""

from __future__ import annotations

import argparse
import os
import zlib
from typing import Callable, List, Tuple

from spokennlp_tpu_torch.configs import EncoderConfig, TopicSegConfig, TrainConfig, WindowingConfig


def add_model_args(p: argparse.ArgumentParser):
    g = p.add_argument_group("model")
    g.add_argument("--model_name_or_path", default=None)
    g.add_argument("--vocab_file", default=None)
    g.add_argument("--ts_score_predictor", default="lt", choices=["lt", "cos"])
    g.add_argument("--ts_score_predictor_cos_temp", type=float, default=1.0)
    g.add_argument("--ts_loss_weight", type=float, default=1.0)
    g.add_argument("--cl_loss_weight", type=float, default=0.0)
    g.add_argument("--tssp_loss_weight", type=float, default=0.0)
    g.add_argument("--cl_temp", type=float, default=0.1)
    g.add_argument("--cl_anchor_level", default="eop_list")
    g.add_argument("--cl_positive_k", type=int, default=1)
    g.add_argument("--cl_negative_k", type=int, default=1)
    g.add_argument("--focal_loss_gamma", type=float, default=0.0)
    g.add_argument("--weight_label_zero", type=float, default=0.5)
    g.add_argument("--do_da_ts", action="store_true")
    g.add_argument("--do_tssp", action="store_true")
    g.add_argument("--tssp_ablation", default="none")
    g.add_argument("--attention_type", default="dense",
                   choices=["dense", "sliding_window", "bigbird", "ponet"])
    g.add_argument("--attention_window", type=int, default=512)
    g.add_argument("--attention_impl", default="auto",
                   choices=["auto", "einsum", "flash", "pallas", "fused",
                            "stack", "train_fused"],
                   help="attention kernel selection (auto = fused Pallas on "
                   "TPU, einsum elsewhere)")
    # HF Trainer flag name; remats each layer on backward (jax.checkpoint)
    g.add_argument("--gradient_checkpointing", action="store_true")
    # architecture knobs (defaults = BERT-base; used when training from
    # scratch / smoke-testing without a checkpoint)
    g.add_argument("--hidden_size", type=int, default=768)
    g.add_argument("--num_hidden_layers", type=int, default=12)
    g.add_argument("--num_attention_heads", type=int, default=12)
    g.add_argument("--intermediate_size", type=int, default=3072)


def add_data_args(p: argparse.ArgumentParser):
    g = p.add_argument_group("data")
    g.add_argument("--dataset_name", default="wiki_section")
    g.add_argument("--data_dir", default=None)
    g.add_argument("--dataset_config_file", default=None,
                   help="config.ini with a [mapping] section")
    g.add_argument("--max_seq_length", type=int, default=512)
    g.add_argument("--max_train_samples", type=int, default=None)
    g.add_argument("--max_eval_samples", type=int, default=None)
    g.add_argument("--max_predict_samples", type=int, default=None)
    g.add_argument("--threshold", type=float, default=None)
    g.add_argument("--topk", type=int, default=None)
    g.add_argument("--topk_with_threshold", action="store_true")
    g.add_argument("--f1_at_k", type=int, default=None)
    g.add_argument("--test_data_name", default="test")


def add_training_args(p: argparse.ArgumentParser):
    g = p.add_argument_group("training")
    g.add_argument("--output_dir", required=True)
    g.add_argument("--do_train", action="store_true")
    g.add_argument("--do_eval", action="store_true")
    g.add_argument("--do_predict", action="store_true")
    g.add_argument("--learning_rate", type=float, default=5e-5)
    g.add_argument("--num_train_epochs", type=float, default=5.0)
    g.add_argument("--per_device_train_batch_size", type=int, default=2)
    g.add_argument("--per_device_eval_batch_size", type=int, default=8)
    g.add_argument("--gradient_accumulation_steps", type=int, default=4)
    g.add_argument("--warmup_ratio", type=float, default=0.0)
    g.add_argument("--weight_decay", type=float, default=0.01)
    g.add_argument("--seed", type=int, default=42)
    g.add_argument("--eval_cnt", type=int, default=5)
    g.add_argument("--metric_for_best_model", default="f1")
    g.add_argument("--save_total_limit", type=int, default=2)
    g.add_argument("--resume_from_checkpoint", default=None)
    g.add_argument("--overwrite_output_dir", action="store_true")
    g.add_argument("--save_hf_format", action="store_true",
                   help="also export <output_dir>/final_model_hf in the "
                   "save_pretrained (pytorch_model.bin) format the reference "
                   "writes (alimeeting4mug/src/models/trainer.py:33-60), so "
                   "ModelScope/transformers pipelines can consume the result")
    g.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    # SPMD: data-parallel over all local devices by default (the reference's
    # torch.distributed.launch DDP); optional tensor-parallel axis + explicit
    # multi-host bootstrap
    g.add_argument("--model_parallel_size", type=int, default=1)
    g.add_argument("--preprocessing_num_workers", type=int, default=1)
    g.add_argument("--report_to", default=None, choices=[None, "tensorboard"],
                   help="tensorboard writes event files under "
                   "<output_dir>/tensorboard")
    g.add_argument("--jax_distributed", action="store_true",
                   help="call jax.distributed.initialize (multi-host; "
                   "coordinator from JAX_COORDINATOR_ADDRESS et al.)")


def resolve_tokenizer(args) -> Tuple[Callable[[str], List[int]], dict]:
    """Return (tokenize_fn, special_ids {cls, pad, bos/eos})."""
    if args.vocab_file:
        from spokennlp_tpu_torch.utils.tokenization import FullTokenizer

        tok = FullTokenizer.from_vocab_file(args.vocab_file)
        vocab = tok.vocab
        bos = vocab.get("[BOS]", vocab.get("[unused1]", 1))
        special = {
            "cls": vocab.get("[CLS]", 101),
            "pad": vocab.get("[PAD]", 0),
            "bos": bos,
            "sep": vocab.get("[SEP]", min(102, len(vocab) - 1)),
            "vocab_size": len(vocab),
        }
        if "[MASK]" in vocab:
            special["mask"] = vocab["[MASK]"]
        return tok.encode, special
    # fallback hash tokenizer (smoke tests without vocab assets); crc32, not
    # the salted hash(), so every interpreter gives the same ids
    V = 30522
    special = {"cls": 101, "pad": 0, "bos": 1, "sep": 102, "mask": 103,
               "vocab_size": V}

    def hash_tokenize(s: str) -> List[int]:
        return [1000 + (zlib.crc32(w.encode()) % (V - 1100)) for w in s.split()] or [1000]

    return hash_tokenize, special


def build_configs(args, special):
    enc = EncoderConfig(
        vocab_size=special["vocab_size"],
        hidden_size=args.hidden_size,
        num_layers=args.num_hidden_layers,
        num_heads=args.num_attention_heads,
        intermediate_size=args.intermediate_size,
        max_position_embeddings=max(args.max_seq_length, 512),
        attention_type=args.attention_type,
        attention_window=args.attention_window,
        attention_impl=getattr(args, "attention_impl", "auto"),
        pad_token_id=special["pad"],
        remat=getattr(args, "gradient_checkpointing", False),
    )
    task = TopicSegConfig(
        ts_score_predictor=args.ts_score_predictor,
        ts_score_predictor_cos_temp=args.ts_score_predictor_cos_temp,
        ts_loss_weight=args.ts_loss_weight,
        cl_loss_weight=args.cl_loss_weight,
        tssp_loss_weight=args.tssp_loss_weight,
        cl_temp=args.cl_temp,
        cl_anchor_level=args.cl_anchor_level,
        cl_positive_k=args.cl_positive_k,
        cl_negative_k=args.cl_negative_k,
        focal_loss_gamma=args.focal_loss_gamma,
        weight_label_zero=args.weight_label_zero,
        do_da_ts=args.do_da_ts,
        do_tssp=args.do_tssp,
        tssp_ablation=args.tssp_ablation,
    )
    wcfg = WindowingConfig(
        max_seq_length=args.max_seq_length,
        cls_token_id=special["cls"],
        pad_token_id=special["pad"],
        bos_token_id=special["bos"],
    )
    tcfg = TrainConfig(
        learning_rate=args.learning_rate,
        num_train_epochs=args.num_train_epochs,
        per_device_batch_size=args.per_device_train_batch_size,
        gradient_accumulation_steps=args.gradient_accumulation_steps,
        warmup_ratio=args.warmup_ratio,
        weight_decay=args.weight_decay,
        seed=args.seed,
        eval_cnt=args.eval_cnt,
        dtype=args.dtype,
        checkpoint_dir=os.path.join(args.output_dir, "checkpoints"),
        save_total_limit=args.save_total_limit,
        model_parallel_size=getattr(args, "model_parallel_size", 1),
        preprocessing_num_workers=getattr(args, "preprocessing_num_workers", 1),
        tensorboard_dir=(
            os.path.join(args.output_dir, "tensorboard")
            if getattr(args, "report_to", None) == "tensorboard"
            else None
        ),
    )
    return enc, task, wcfg, tcfg


def load_docs(args, tokenize_fn):
    from spokennlp_tpu_torch.data import corpora

    data_dir = args.data_dir
    if data_dir is None and args.dataset_config_file:
        mapping = corpora.dataset_folder_mapping(args.dataset_config_file)
        data_dir = mapping[args.dataset_name]
    assert data_dir, "need --data_dir or --dataset_config_file"
    splits = corpora.load_dataset_splits(args.dataset_name, data_dir)
    out = {}
    for split, examples in splits.items():
        limit = {
            "train": args.max_train_samples,
            "validation": args.max_eval_samples,
            "test": args.max_predict_samples,
        }[split]
        if limit:
            examples = examples[:limit]
        out[split] = corpora.tokenize_examples(examples, tokenize_fn)
    return out
