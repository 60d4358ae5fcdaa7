"""Shared CLI plumbing of the port.

The flag groups, tokenizer resolution and corpus loading are the JAX
package's (``spokennlp_tpu/cli/common.py``), which import neither jax nor
flax. ``build_configs`` is its twin without the jax import.
"""

from __future__ import annotations

import os

from spokennlp_tpu.cli.common import (  # noqa: F401  (re-exported)
    add_data_args,
    add_model_args,
    add_training_args,
    load_docs,
    resolve_tokenizer,
)
from spokennlp_tpu.configs import EncoderConfig, TopicSegConfig, TrainConfig, WindowingConfig


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
