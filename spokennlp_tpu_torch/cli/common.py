"""Shared CLI plumbing of the port: flag groups, tokenizer resolution,
configs, checkpoint loading and corpus loading.

The port's own copy of ``spokennlp_tpu/cli/common.py``'s flag groups,
``resolve_tokenizer``, ``build_configs``, ``maybe_load_pretrained``,
``resize_word_embeddings``, ``maybe_init_distributed`` and ``load_docs``,
with the same flags and defaults (``--jax_distributed`` keeps its name and
joins a ``torch.distributed`` process group). ``resolve_tokenizer`` reads
a checkpoint directory's WordPiece ``vocab.txt`` (the JAX package's
``AutoTokenizer`` path for BERT-style tokenizers, ``[BOS]`` added where the
vocabulary lacks it), a ``--vocab_file``, or falls back to hashing words with ``zlib.crc32``, where
the JAX package's uses the salted ``hash()``: the same flags give the same
ids in every interpreter, and other ids than JAX's. ``maybe_load_pretrained``
reads the directory without ``transformers`` (``cli/hf_checkpoint.py``) and
raises where it cannot, where the JAX package warns and starts from random
weights.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import zlib
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

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
                   help="join a torch.distributed process group (data parallel; "
                   "address, world size and rank from torchrun's MASTER_ADDR, "
                   "MASTER_PORT, WORLD_SIZE and RANK; NCCL on cuda, gloo on cpu); "
                   "torchrun with WORLD_SIZE > 1 joins without the flag")


def resolve_tokenizer(args) -> Tuple[Callable[[str], List[int]], dict]:
    """Return (tokenize_fn, special_ids {cls, pad, bos/eos})."""
    path = args.model_name_or_path
    if path and os.path.isfile(os.path.join(path, "vocab.txt")):
        from spokennlp_tpu_torch.utils.tokenization import FullTokenizer

        lower = True
        tok_cfg = os.path.join(path, "tokenizer_config.json")
        if os.path.exists(tok_cfg):
            with open(tok_cfg) as f:
                lower = bool(json.load(f).get("do_lower_case", True))
        tok = FullTokenizer.from_vocab_file(os.path.join(path, "vocab.txt"), do_lower_case=lower)
        vocab = tok.vocab
        # a BERT vocabulary has no BOS: [BOS] is added as a new token, as
        # the reference does before resizing the embeddings
        bos = vocab.get("[BOS]", len(vocab))
        special = {
            "cls": vocab.get("[CLS]", bos),
            "pad": vocab.get("[PAD]", 0),
            "bos": bos,
            "sep": vocab.get("[SEP]", 102),
            "vocab_size": max(len(vocab), bos + 1),
        }
        if "[MASK]" in vocab:
            special["mask"] = vocab["[MASK]"]
        return tok.encode, special
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


def maybe_init_distributed(args) -> bool:
    """Join the process group (parallel/dist.py) behind ``--jax_distributed``,
    or when torchrun started several processes (``WORLD_SIZE`` > 1): JAX sees
    every local device from one process, the port runs one process a card.
    Inside a group ``args.device`` "cuda" becomes this process's card.
    Returns whether this call made the group (its caller leaves it at the
    end). Without either, or without torchrun's environment, a no-op."""
    from spokennlp_tpu_torch.parallel import dist

    joined = False
    if getattr(args, "jax_distributed", False) or int(os.environ.get("WORLD_SIZE", "1")) > 1:
        joined = dist.initialize_distributed(device=args.device)
    if dist.is_distributed():
        args.device = str(dist.process_device(args.device))
    return joined


def place_on_mesh(model: torch.nn.Module, model_parallel_size: int) -> torch.nn.Module:
    """Lay the process group out as JAX's ``make_mesh`` does ((world // mp,
    mp): data and model axes) and cut ``model``'s parameters to this rank's
    shards by JAX's partition rule (``parallel/mesh.py``); raises, naming
    the flag, when mp does not divide the world size. One process, mp 1: a
    no-op."""
    from spokennlp_tpu_torch.parallel import dist
    from spokennlp_tpu_torch.parallel.mesh import shard_module_

    dist.make_mesh(model_parallel_size)
    shard_module_(model, dist.model_axis())
    return model


def maybe_load_pretrained(args, enc_cfg) -> Optional[Tuple[EncoderConfig, Dict]]:
    """``--model_name_or_path`` -> (config, parameter tree), or None without
    one. A native checkpoint (``params.msgpack`` and ``config.json``,
    ``models/checkpoint_io.py``; its config, else ``enc_cfg``) gives its whole
    tree; an HF directory of type bert, longformer, electra or big_bird
    (``cli/hf_checkpoint.py``) the trunk's, with any task heads beside it
    under ``"encoder"``. The CLI's ``--attention_impl`` and
    ``--gradient_checkpointing`` apply on top of the checkpoint's config.
    A path that is not a directory, or a directory that cannot be read,
    raises."""
    path = args.model_name_or_path
    if not path:
        return None
    if not os.path.isdir(path):
        raise FileNotFoundError(f"--model_name_or_path {path}: not a directory (the port reads "
                                "local checkpoints only)")
    from spokennlp_tpu_torch.models import checkpoint_io

    if checkpoint_io.is_native_checkpoint(path):
        params, cfg = checkpoint_io.load_checkpoint(path)
        cfg = cfg or enc_cfg
    else:
        from spokennlp_tpu_torch.cli import hf_checkpoint

        cfg, params = hf_checkpoint.load_hf_checkpoint(path)
    cfg = dataclasses.replace(cfg, attention_impl=enc_cfg.attention_impl, remat=enc_cfg.remat)
    return cfg, params


def resize_word_embeddings(params, enc_cfg, new_vocab_size: int, seed: int = 0):
    """Grow word_embeddings to ``new_vocab_size`` rows; returns (params, cfg).

    The reference calls model.resize_token_embeddings(len(tokenizer)) after
    adding the [BOS] special token (ts_sentence_seq_labeling.py:282-284);
    without this, the new token id would fall past the table. New rows are
    drawn N(0, 0.02) from numpy's generator at ``seed``, like HF's resize
    and as the JAX package draws them. Accepts either a trunk tree
    (embeddings at the top) or a task-model tree (under "encoder")."""
    trunk = params.get("encoder", params)
    emb = np.asarray(trunk["embeddings"]["word_embeddings"]["embedding"])
    old_vocab, width = emb.shape
    if new_vocab_size <= old_vocab:
        if enc_cfg.vocab_size != old_vocab:
            enc_cfg = dataclasses.replace(enc_cfg, vocab_size=old_vocab)
        return params, enc_cfg
    extra = (
        np.random.default_rng(seed)
        .normal(0.0, 0.02, size=(new_vocab_size - old_vocab, width))
        .astype(emb.dtype)
    )
    new_trunk = dict(trunk)
    new_emb_scope = dict(trunk["embeddings"])
    new_emb_scope["word_embeddings"] = {"embedding": np.concatenate([emb, extra], axis=0)}
    new_trunk["embeddings"] = new_emb_scope
    if "encoder" in params:
        params = dict(params)
        params["encoder"] = new_trunk
    else:
        params = new_trunk
    return params, dataclasses.replace(enc_cfg, vocab_size=new_vocab_size)


def load_pretrained_into(model: torch.nn.Module, params: Dict):
    """Put a parameter tree from ``maybe_load_pretrained`` into ``model``: a
    task tree's every module, or a trunk's under ``encoder``; what the tree
    does not hold keeps its initialisation. A name the model lacks or a
    shape it does not have raises. A model-sharded model takes its slices of
    the (whole) tree."""
    from spokennlp_tpu_torch.models.checkpoint_io import load_state_
    from spokennlp_tpu_torch.models.convert import jax_params_to_state_dict
    from spokennlp_tpu_torch.parallel.mesh import gather_state_dict

    loaded = jax_params_to_state_dict(params if "encoder" in params else {"encoder": params})
    sd = gather_state_dict(model)
    unknown = sorted(set(loaded) - set(sd))
    if unknown:
        raise KeyError(f"the checkpoint holds parameters the model lacks: {unknown[:8]}")
    sd.update(loaded)
    load_state_(model, sd)


def merge_trunk(encoder: torch.nn.Module, trunk: Dict, keys=("encoder",)):
    """Put a checkpoint's trunk into ``encoder`` leaf by leaf, as the JAX
    CLIs deep-merge it into the fresh encoder subtree: the subtree under the
    first of ``keys`` the tree holds (else the bare tree); leaves the
    checkpoint lacks keep their initialisation, leaves the model lacks are
    left out (Flax's apply ignores them)."""
    from spokennlp_tpu_torch.models.convert import jax_params_to_state_dict

    sub = next((trunk[k] for k in keys if k in trunk), trunk)
    sd = encoder.state_dict()
    sd.update({k: v for k, v in jax_params_to_state_dict(sub).items() if k in sd})
    encoder.load_state_dict(sd, strict=True)


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
