"""MLM+NSP further-pretraining CLI on PyTorch.

Counterpart of ``spokennlp_tpu/cli/run_pretrain_mlm.py``: the same flags and
defaults (BERT-base, 128 tokens, batch 8, float32), plus ``--device``
(``cuda`` by default; it raises when no card is present). Meetings JSONL
(``{"sentences": [{"text": ...}]}``) or plain text (one sentence a line, a
blank line between documents) -> masked-LM + NSP pretraining of the trunk
(``objectives/mlm.py``) on the port's AdamW with linear warmup
(``train/optim.py``) -> ``<output_dir>/pretrained_model``, a native
checkpoint of the trunk (``models/checkpoint_io.py``) that ``run_finetune
--model_name_or_path`` reads, and ``pretrain_results.json`` (one entry an
epoch). On the card the trunk trains on the training kernels (rows 10 and 11
of the kernel table).

    python -m spokennlp_tpu_torch.cli.run_pretrain_mlm --train_file meetings.jsonl \
        --output_dir ./pretrained --num_train_epochs 3
"""

from __future__ import annotations

import argparse
import json
import os
import time


def load_documents(path, tokenize_fn):
    """-> list of documents, each a list of per-sentence token-id lists."""
    docs = []
    if path.endswith(".jsonl"):
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                row = json.loads(line)
                sents = [s["text"] if isinstance(s, dict) else s for s in row["sentences"]]
                toks = [tokenize_fn(s) for s in sents]
                docs.append([t for t in toks if t])
    else:  # plain text: blank-line-separated documents
        cur = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    if cur:
                        docs.append(cur)
                        cur = []
                    continue
                t = tokenize_fn(line)
                if t:
                    cur.append(t)
        if cur:
            docs.append(cur)
    return [d for d in docs if len(d) >= 2]


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--train_file", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--model_name_or_path", default=None)
    p.add_argument("--vocab_file", default=None)
    p.add_argument("--max_seq_length", type=int, default=128)
    p.add_argument("--max_predictions_per_seq", type=int, default=20)
    p.add_argument("--masked_lm_prob", type=float, default=0.15)
    p.add_argument("--learning_rate", type=float, default=5e-5)
    p.add_argument("--num_train_epochs", type=float, default=2.0)
    p.add_argument("--per_device_train_batch_size", type=int, default=8)
    p.add_argument("--warmup_ratio", type=float, default=0.1)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--hidden_size", type=int, default=768)
    p.add_argument("--num_hidden_layers", type=int, default=12)
    p.add_argument("--num_attention_heads", type=int, default=12)
    p.add_argument("--intermediate_size", type=int, default=3072)
    p.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--device", default="cuda",
                   help="torch device to run on; cuda raises when no card is present")
    return p


def main(argv=None):
    args = make_parser().parse_args(argv)
    import numpy as np
    import torch

    from spokennlp_tpu_torch.cli import common
    from spokennlp_tpu_torch.cli.run_inference import resolve_device
    from spokennlp_tpu_torch.configs import EncoderConfig, TrainConfig
    from spokennlp_tpu_torch.models import checkpoint_io
    from spokennlp_tpu_torch.models.convert import jax_params_to_state_dict
    from spokennlp_tpu_torch.objectives.mlm import (
        BertForPreTraining, PretrainDataConfig, build_pretraining_batch, pretraining_loss,
    )
    from spokennlp_tpu_torch.train import optim
    from spokennlp_tpu_torch.train.train_step import batch_to_device, step_generator

    device = resolve_device(args.device)
    os.makedirs(args.output_dir, exist_ok=True)
    tokenize_fn, special = common.resolve_tokenizer(args)
    dcfg = PretrainDataConfig(
        cls_token_id=special["cls"],
        sep_token_id=special["sep"],
        pad_token_id=special["pad"],
        mask_token_id=special.get("mask", 103),
    )
    # an out-of-vocab mask id silently NaNs training (an embedding gather
    # past the table; a [MASK]-less specials dict defaulted to 103 against
    # an 88-entry vocab)
    assert dcfg.mask_token_id < special["vocab_size"], (
        f"mask token id {dcfg.mask_token_id} outside vocab "
        f"{special['vocab_size']} — tokenizer must define [MASK]")
    docs = load_documents(args.train_file, tokenize_fn)
    assert docs, "no >=2-sentence documents in the corpus"

    enc_cfg = EncoderConfig(
        vocab_size=special["vocab_size"],
        hidden_size=args.hidden_size,
        num_layers=args.num_hidden_layers,
        num_heads=args.num_attention_heads,
        intermediate_size=args.intermediate_size,
        max_position_embeddings=max(args.max_seq_length, 512),
        pad_token_id=special["pad"],
        add_pooler=True,
    )
    trunk = None
    pretrained = common.maybe_load_pretrained(args, enc_cfg)
    if pretrained is not None:
        enc_cfg, trunk = pretrained
        trunk = trunk.get("encoder", trunk)
        trunk, enc_cfg = common.resize_word_embeddings(trunk, enc_cfg, special["vocab_size"],
                                                       seed=args.seed)

    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    model = BertForPreTraining(enc_cfg, dtype=dtype,
                               generator=torch.Generator().manual_seed(args.seed))
    if trunk is not None:
        model.encoder.load_state_dict(jax_params_to_state_dict(trunk), strict=True)
    model = model.to(device)

    rng = np.random.default_rng(args.seed)
    # one featurization pass to size the schedule
    full = build_pretraining_batch(
        docs, dcfg, np.random.default_rng(args.seed), args.max_seq_length,
        args.max_predictions_per_seq, args.masked_lm_prob, special["vocab_size"],
    )
    bs = args.per_device_train_batch_size
    steps_per_epoch = max(full["input_ids"].shape[0] // bs, 1)
    total_steps = max(int(steps_per_epoch * args.num_train_epochs), 1)
    tcfg = TrainConfig(learning_rate=args.learning_rate, warmup_ratio=args.warmup_ratio,
                       gradient_accumulation_steps=1, seed=args.seed)
    optimizer = optim.make_optimizer(model, tcfg, total_steps)

    def train_step(batch):
        model.train()
        generator = step_generator(device, args.seed, optimizer.micro_step)
        out = model(batch["input_ids"], batch["attention_mask"], batch["token_type_ids"],
                    batch["mlm_positions"], generator=generator)
        loss, aux = pretraining_loss(out, batch)
        grads = torch.autograd.grad(loss, optimizer.params, allow_unused=True)
        # a parameter the loss does not reach gets a zero gradient, as
        # jax.grad gives it
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(optimizer.params, grads)]
        metrics = {"loss": loss.detach(), **{k: v.detach() for k, v in aux.items()},
                   "grad_norm": optim.global_norm(grads)}
        optimizer.step(grads)
        return metrics

    history, step_ends = [], []
    step = 0
    epoch = 0
    t_start = time.perf_counter()
    while step < total_steps:
        epoch += 1
        # re-sample the masking every epoch (the reference regenerates its
        # tfrecords with dupe_factor; fresh masks an epoch are the same idea)
        full = build_pretraining_batch(
            docs, dcfg, rng, args.max_seq_length, args.max_predictions_per_seq,
            args.masked_lm_prob, special["vocab_size"],
        )
        order = rng.permutation(full["input_ids"].shape[0])
        for s in range(0, len(order), bs):
            take = order[s:s + bs].tolist()
            while len(take) < bs:
                take.append(take[0])
            m = train_step(batch_to_device({k: v[take] for k, v in full.items()}, device))
            m = {k: float(v) for k, v in m.items()}  # waits for the step
            step_ends.append(time.perf_counter())
            step += 1
            if step >= total_steps:
                break
        history.append({"epoch": epoch, "step": step, **m})
        print(json.dumps(history[-1]))
    train_time = time.perf_counter() - t_start

    # the trunk at the top level: task CLIs graft it under "encoder"
    checkpoint_io.save_checkpoint(
        os.path.join(args.output_dir, "pretrained_model"),
        checkpoint_io.params_from_state_dict(model.encoder.state_dict()), enc_cfg,
    )
    with open(os.path.join(args.output_dir, "pretrain_results.json"), "w") as f:
        json.dump(history, f, indent=2)
    # the steady rate leaves out the first step (the card's warm-up)
    steady = ((len(step_ends) - 1) * bs / (step_ends[-1] - step_ends[0])
              if len(step_ends) > 1 else None)
    return {"history": history, "final": history[-1], "steps": step,
            "train_time_s": train_time, "sequences_per_s": steady}


if __name__ == "__main__":
    main()
