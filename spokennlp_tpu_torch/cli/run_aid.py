"""Action-item detection training CLI (Context-Drop / R-Drop), on PyTorch.

Counterpart of ``spokennlp_tpu/cli/run_aid.py`` (the reference's TF1
estimator script, action-item-detection/script/run_classifier.py) with the
same flags plus ``--device`` (default ``cuda``; raises without a card):
sentence + context classification with example doubling (R-Drop,
Context-Drop fix / dynamic), cls / sep / token_avg / token_max classifier
inputs, focal loss / label smoothing, the symmetric KL between paired
logits (projects/action_item.py), and positive-F1 eval gating: the best
epoch's model is written to ``<output_dir>/best_model`` (native checkpoint,
models/checkpoint_io.py) and, with ``--save_hf_format``, to
``best_model_hf`` (models/hf_export.py).

As in JAX: ``--model_name_or_path`` (a native checkpoint or an HF
directory, cli/common.py) gives the architecture and the trunk, merged into
the fresh encoder (what the checkpoint lacks, such as the pooler, keeps its
initialisation; what the model lacks is left out); the optimizer is optax's
``adamw(lr, weight_decay=0.01)`` (decay on every parameter); each epoch
rebuilds the pairs from one ``np.random.default_rng(seed)``, shuffles whole
pairs and fills the short batch with the batch's first example. On the card
the trunk trains on the training kernels (rows 10 and 11, once a layer a
step) and evaluates batches of at most 32 on the whole-stack kernel
(kernel 3).

Input: meetings jsonl, rows {"sentences": [{"text": ..., "label": 0/1}]}
(``run_process_data --dataset ami --ami_meetings_jsonl`` writes them).

    python -m spokennlp_tpu_torch.cli.run_aid --train_file train_meetings.jsonl \\
        --eval_file dev_meetings.jsonl --output_dir out
"""

from __future__ import annotations

import argparse
import json
import os


def ami_rows_to_meetings(rows):
    """data/ami.py row dicts -> the meetings jsonl structure."""
    meetings = {}
    for r in rows:
        meetings.setdefault(r["meeting_name"], []).append(
            {"text": r["sentence"], "label": int(r["action_label"])}
        )
    return [{"meeting": k, "sentences": v} for k, v in sorted(meetings.items())]


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--train_file", required=True)
    p.add_argument("--eval_file", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--model_name_or_path", default=None)
    p.add_argument("--classifier_input", default="cls",
                   choices=["cls", "sep", "token_avg", "token_max"])
    p.add_argument("--drop_type", default="context-drop-dynamic",
                   choices=["none", "r-drop", "context-drop-fix",
                            "context-drop-dynamic"])
    p.add_argument("--noisy_type", default="update",
                   choices=["skip", "update", "remain"])
    p.add_argument("--loss_type", default="ce", choices=["ce", "focal_loss"])
    p.add_argument("--do_label_smoothing", action="store_true")
    p.add_argument("--kl_alpha", type=float, default=1.0)
    p.add_argument("--context_width", type=int, default=2)
    p.add_argument("--use_global_context", action="store_true")
    p.add_argument("--max_seq_length", type=int, default=128)
    p.add_argument("--per_device_train_batch_size", type=int, default=16)
    p.add_argument("--num_train_epochs", type=int, default=3)
    p.add_argument("--learning_rate", type=float, default=3e-5)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--save_hf_format", action="store_true",
                   help="also export best_model_hf in save_pretrained format")
    p.add_argument("--hidden_size", type=int, default=768)
    p.add_argument("--num_hidden_layers", type=int, default=12)
    p.add_argument("--num_attention_heads", type=int, default=12)
    p.add_argument("--intermediate_size", type=int, default=3072)
    p.add_argument("--device", default="cuda",
                   help="torch device to run on; cuda raises when no card is present")
    return p


def main(argv=None):
    args = make_parser().parse_args(argv)
    os.makedirs(args.output_dir, exist_ok=True)

    import dataclasses as dc

    import numpy as np
    import torch

    from spokennlp_tpu_torch.cli import common
    from spokennlp_tpu_torch.cli.run_inference import resolve_device
    from spokennlp_tpu_torch.configs import EncoderConfig
    from spokennlp_tpu_torch.eval.seg_metrics import binary_prf
    from spokennlp_tpu_torch.models import checkpoint_io
    from spokennlp_tpu_torch.projects.action_item import (
        AidConfig,
        AidModel,
        build_paired_examples,
        collate_examples,
        make_aid_train_step,
    )

    device = resolve_device(args.device)
    ns = argparse.Namespace(model_name_or_path=args.model_name_or_path, vocab_file=None)
    tokenize_fn, special = common.resolve_tokenizer(ns)

    cfg = AidConfig(
        classifier_input=args.classifier_input,
        loss_type=args.loss_type,
        do_label_smoothing=args.do_label_smoothing,
        kl_alpha=args.kl_alpha,
        drop_type=args.drop_type,
        noisy_type=args.noisy_type,
        max_seq_length=args.max_seq_length,
    )

    def load_meetings(path):
        with open(path) as f:
            return [json.loads(l) for l in f if l.strip()]

    train_meetings = load_meetings(args.train_file)
    eval_meetings = load_meetings(args.eval_file)

    enc_cfg = EncoderConfig(
        vocab_size=special["vocab_size"],
        hidden_size=args.hidden_size,
        num_layers=args.num_hidden_layers,
        num_heads=args.num_attention_heads,
        intermediate_size=args.intermediate_size,
        max_position_embeddings=max(args.max_seq_length, 512),
        pad_token_id=special["pad"],
        add_pooler=args.classifier_input == "cls",
    )
    pretrained = common.maybe_load_pretrained(ns, enc_cfg)
    trunk = None
    if pretrained is not None:
        # adopt the checkpoint's architecture and resize the embeddings for
        # the tokenizer's growth ([BOS] etc.)
        loaded_cfg, trunk = pretrained
        trunk, loaded_cfg = common.resize_word_embeddings(
            trunk, loaded_cfg, special["vocab_size"], seed=args.seed)
        enc_cfg = dc.replace(loaded_cfg, add_pooler=args.classifier_input == "cls")
    model = AidModel(enc_cfg, cfg, generator=torch.Generator().manual_seed(args.seed))
    if trunk is not None:
        common.merge_trunk(model.encoder, trunk)
    model = model.to(device)

    optimizer = torch.optim.AdamW(model.parameters(), lr=args.learning_rate,
                                  betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01)
    step_fn = make_aid_train_step(model, cfg, optimizer,
                                  torch.Generator(device=device).manual_seed(args.seed))
    data_rng = np.random.default_rng(args.seed)
    cls_id, sep_id = special["cls"], special.get("sep", 102)
    to_device = lambda batch: {k: torch.from_numpy(v).to(device) for k, v in batch.items()}

    # eval examples: no doubling or noise (the reference predicts single rows)
    eval_cfg = dc.replace(cfg, drop_type="none", noisy_type="remain")
    eval_examples = []
    for m in eval_meetings:
        eval_examples.extend(build_paired_examples(m["sentences"], eval_cfg, data_rng,
                                                   args.context_width, args.use_global_context))

    bs = args.per_device_train_batch_size

    def evaluate():
        model.eval()
        preds, labels = [], []
        with torch.no_grad():
            for s in range(0, len(eval_examples), bs):
                chunk = eval_examples[s : s + bs]
                real = len(chunk)
                while len(chunk) < bs:
                    chunk = chunk + chunk[: bs - len(chunk)]
                batch = to_device(collate_examples(chunk, tokenize_fn, cfg, cls_id, sep_id))
                logits = model(batch["input_ids"], batch["attention_mask"],
                               batch["token_type_ids"], batch["sep_position"])
                preds.extend(torch.argmax(logits, -1).cpu().numpy()[:real].tolist())
                labels.extend(int(c["label"]) for c in chunk[:real])
        return binary_prf(preds, labels)

    history, best_f1 = [], -1.0
    for epoch in range(1, args.num_train_epochs + 1):
        examples = []
        for m in train_meetings:
            examples.extend(build_paired_examples(m["sentences"], cfg, data_rng,
                                                  args.context_width, args.use_global_context))
        if cfg.drop_type == "none":
            # no consistency pairing: a plain example shuffle
            order = data_rng.permutation(len(examples)).tolist()
        else:
            # keep consistency pairs adjacent inside a batch: shuffle PAIRS
            # (the paired modes emit examples two at a time)
            assert len(examples) % 2 == 0, len(examples)
            pair_starts = list(range(0, len(examples), 2))
            data_rng.shuffle(pair_starts)
            order = [i for s in pair_starts for i in (s, s + 1)]
        losses = []
        for s in range(0, len(order), bs):
            take = order[s : s + bs]
            while len(take) < bs:
                take.append(take[0])
            batch = collate_examples([examples[i] for i in take], tokenize_fn, cfg, cls_id,
                                     sep_id)
            metrics = step_fn(to_device(batch))
            losses.append(float(metrics["loss"]))
        m = evaluate()
        row = {"epoch": epoch, "train_loss": float(np.mean(losses)),
               "positive_f1": 100 * m["f1"], "precision": 100 * m["precision"],
               "recall": 100 * m["recall"]}
        history.append(row)
        print(json.dumps(row))
        if m["f1"] > best_f1:
            best_f1 = m["f1"]
            params = checkpoint_io.params_from_state_dict(model.state_dict())
            checkpoint_io.save_checkpoint(os.path.join(args.output_dir, "best_model"), params,
                                          enc_cfg)
            if args.save_hf_format:
                from spokennlp_tpu_torch.models import hf_export

                hf_export.save_hf_checkpoint(os.path.join(args.output_dir, "best_model_hf"),
                                             params, enc_cfg)

    results = {"history": history, "best_positive_f1": 100 * best_f1}
    with open(os.path.join(args.output_dir, "aid_results.json"), "w") as f:
        json.dump(results, f, indent=2, default=float)
    return results


if __name__ == "__main__":
    main()
