"""SLD training CLI: discrete-speech-token ASR with smoothed label
distillation, on PyTorch.

Counterpart of ``spokennlp_tpu/cli/run_sld.py`` (the reference's stage-7
``accelerate launch run_clm.py``, sld/run.sh:231, run_clm.py:350-905) with
the same flags plus ``--device`` (default ``cuda``; raises without a card):
packed speech+text blocks, the composite CE + CE + T^2 KL loss with 30%
input time-masking, per-epoch decode -> WER/CER, best-checkpoint retention
(projects/sld.py).

As in JAX: the optimizer is optax's ``adamw(lr)``, which decays every
parameter at 1e-4 (``torch.optim.AdamW(weight_decay=1e-4)``; torch's own
default of 1e-2 is not it), on the ``linear`` schedule (optional warmup,
then linear decay to 0 over training; train/optim.py) or a constant rate,
after optional global-norm clipping. Without a checkpoint the text is
tokenized by a word vocabulary built from the corpus (exactly invertible,
so WER is well defined) and GPT-2 starts from its init drawn from
``torch.Generator().manual_seed(seed)``.

Two departures from JAX, which warns and carries on: ``--model_name_or_path``
must be a GPT-2 directory whose weights load (read without ``transformers``
by models/gpt2.py ``read_gpt2_checkpoint``, then resized to the speech
vocabulary), else the run raises rather than train from scratch; and its
tokenizer is read with ``transformers``' ``AutoTokenizer``, without which
the run raises rather than put the checkpoint's rows under a word
vocabulary's ids.

Input jsonl rows: {"speech_tokens": [int, ...], "text": "..."} (the output
of projects/sld_pipeline.py).

    python -m spokennlp_tpu_torch.cli.run_sld --train_file train.jsonl \\
        --eval_file valid.jsonl --output_dir out
"""

from __future__ import annotations

import argparse
import json
import os


def _load_rows(path):
    with open(path) as f:
        return [json.loads(l) for l in f if l.strip()]


def _word_vocab(rows_list):
    vocab = {}
    for rows in rows_list:
        for r in rows:
            for w in r["text"].split():
                vocab.setdefault(w, len(vocab))
    inv = {i: w for w, i in vocab.items()}
    return (
        lambda s: [vocab[w] for w in s.split()],
        lambda ids: " ".join(inv.get(int(i), "<unk>") for i in ids),
        len(vocab),
    )


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--train_file", required=True)
    p.add_argument("--eval_file", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--model_name_or_path", default=None,
                   help="HF GPT-2 checkpoint dir (tokenizer + weights)")
    p.add_argument("--vocab_size_speech", type=int, default=2000)
    p.add_argument("--block_size", type=int, default=1024)
    p.add_argument("--max_text_length", type=int, default=256)
    p.add_argument("--per_device_train_batch_size", type=int, default=8)
    p.add_argument("--num_train_epochs", type=int, default=3)
    p.add_argument("--learning_rate", type=float, default=5e-5)
    p.add_argument("--lr_scheduler_type", default="linear",
                   choices=["linear", "constant"],
                   help="reference parity: run_clm.py uses get_scheduler "
                   "with the 'linear' default (decay to 0 over training)")
    p.add_argument("--num_warmup_steps", type=int, default=0)
    p.add_argument("--weight_ce_speech", type=float, default=1.0)
    p.add_argument("--weight_ce_text", type=float, default=1.0)
    p.add_argument("--weight_kl_speech", type=float, default=1.0)
    p.add_argument("--kl_temperature", type=float, default=1.0)
    p.add_argument("--time_masking", type=float, default=0.3)
    p.add_argument("--num_beams", type=int, default=1)
    p.add_argument("--decode_max_len", type=int, default=None)
    p.add_argument("--clip_grad_norm", type=float, default=0.0,
                   help="global-norm gradient clipping (0 = off, matching "
                   "the reference run_clm.py loop)")
    p.add_argument("--seed", type=int, default=42)
    # tiny-model knobs for smoke runs without a checkpoint
    p.add_argument("--hidden_size", type=int, default=768)
    p.add_argument("--num_hidden_layers", type=int, default=12)
    p.add_argument("--num_attention_heads", type=int, default=12)
    p.add_argument("--intermediate_size", type=int, default=None,
                   help="GPT-2 n_inner; default 4*hidden (HF semantics)")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on; cuda raises when no card is present")
    return p


def load_pretrained(path: str, gcfg, total_vocab: int, seed: int):
    """The parameter tree of the GPT-2 directory ``path`` for ``gcfg``,
    its token table resized to ``total_vocab`` rows; raises where the
    directory's widths differ from ``gcfg``'s."""
    from spokennlp_tpu_torch.models.gpt2 import (
        gpt2_hf_to_params, read_gpt2_checkpoint, resize_token_embeddings,
    )

    hf_cfg, sd = read_gpt2_checkpoint(path)
    want = {"n_embd": gcfg.hidden_size, "n_layer": gcfg.num_layers,
            "n_head": gcfg.num_heads,
            "n_inner": gcfg.intermediate_size}
    have = dict(hf_cfg)
    have["n_inner"] = have.get("n_inner") or 4 * have.get("n_embd", 768)
    wrong = {k: (have.get(k), v) for k, v in want.items() if have.get(k) != v}
    if wrong:
        raise ValueError(f"{path}: the checkpoint's widths differ from the flags' "
                         f"(checkpoint, flags): {wrong}")
    prefix = "transformer." if "transformer.wte.weight" in sd else ""
    return resize_token_embeddings(gpt2_hf_to_params(sd, gcfg, prefix), total_vocab, seed)


def main(argv=None):
    args = make_parser().parse_args(argv)
    os.makedirs(args.output_dir, exist_ok=True)

    import torch

    from spokennlp_tpu_torch.cli.run_inference import resolve_device
    from spokennlp_tpu_torch.models.convert import jax_params_to_state_dict
    from spokennlp_tpu_torch.models.gpt2 import GPT2Config, GPT2LMModel
    from spokennlp_tpu_torch.projects.sld import SLDConfig, SLDTrainer, pack_example
    from spokennlp_tpu_torch.train.optim import linear_warmup_schedule

    device = resolve_device(args.device)
    train_rows = _load_rows(args.train_file)
    eval_rows = _load_rows(args.eval_file)

    path = args.model_name_or_path
    tok = None
    if path:
        if not os.path.isdir(path):
            raise FileNotFoundError(f"--model_name_or_path {path}: not a directory (the port "
                                    "reads local checkpoints only)")
        try:
            from transformers import AutoTokenizer
        except ImportError as e:
            raise RuntimeError(f"--model_name_or_path {path}: its tokenizer is read with "
                               "transformers' AutoTokenizer, which does not import here") from e
        tok = AutoTokenizer.from_pretrained(path)
        encode = lambda s: tok(s, add_special_tokens=False)["input_ids"]
        detok = lambda ids: tok.decode(ids)
        gpt_vocab = len(tok)
    else:
        encode, detok, gpt_vocab = _word_vocab([train_rows, eval_rows])
        gpt_vocab += 1  # reserve eos

    cfg = SLDConfig(
        gpt_vocab_size=gpt_vocab,
        vocab_size_speech=args.vocab_size_speech,
        block_size=args.block_size,
        max_text_length=args.max_text_length,
        weight_ce_speech=args.weight_ce_speech,
        weight_ce_text=args.weight_ce_text,
        weight_kl_speech=args.weight_kl_speech,
        kl_temperature=args.kl_temperature,
        time_masking=args.time_masking,
        eos_token_id=gpt_vocab - 1 if tok is None else tok.eos_token_id,
    )

    def packs(rows):
        out, texts = [], []
        for r in rows:
            ex = pack_example(r["speech_tokens"], encode(r["text"]), cfg)
            if ex is not None:
                out.append(ex)
                texts.append(r["text"])
        return out, texts

    train_ex, _ = packs(train_rows)
    eval_ex, eval_texts = packs(eval_rows)

    gcfg = GPT2Config(
        vocab_size=cfg.total_vocab,
        hidden_size=args.hidden_size,
        num_layers=args.num_hidden_layers,
        num_heads=args.num_attention_heads,
        intermediate_size=args.intermediate_size or 4 * args.hidden_size,
        max_position_embeddings=max(args.block_size, 1024),
    )
    model = GPT2LMModel(gcfg, generator=torch.Generator().manual_seed(args.seed))
    if path:
        params = load_pretrained(path, gcfg, cfg.total_vocab, args.seed)
        model.load_state_dict(jax_params_to_state_dict(params), strict=True)
        print("loaded + vocab-extended pretrained GPT-2")
    model = model.to(device)

    # reference-parity LR schedule (run_clm.py: accelerate get_scheduler,
    # default "linear" = optional warmup then linear decay to 0)
    bs = args.per_device_train_batch_size
    if args.lr_scheduler_type == "linear":
        steps_per_epoch = max(1, (len(train_ex) + bs - 1) // bs)
        schedule = linear_warmup_schedule(args.learning_rate,
                                          steps_per_epoch * args.num_train_epochs,
                                          args.num_warmup_steps)
    else:
        schedule = lambda step: args.learning_rate
    optimizer = torch.optim.AdamW(model.parameters(), lr=args.learning_rate,
                                  betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)
    base = args.learning_rate
    scheduler = torch.optim.lr_scheduler.LambdaLR(
        optimizer, lambda n: schedule(n) / base if base else 0.0)
    trainer = SLDTrainer(
        model, cfg, optimizer,
        train_ex, eval_ex, eval_texts, detok,
        batch_size=bs,
        num_epochs=args.num_train_epochs,
        seed=args.seed,
        decode_max_len=args.decode_max_len or args.block_size,
        num_beams=args.num_beams,
        checkpoint_dir=os.path.join(args.output_dir, "checkpoints"),
        scheduler=scheduler,
        clip_grad_norm=args.clip_grad_norm,
    )
    res = trainer.train()
    with open(os.path.join(args.output_dir, "sld_results.json"), "w") as f:
        json.dump(res, f, indent=2, default=float)
    print(json.dumps(res["final"], indent=2, default=float))
    return res


if __name__ == "__main__":
    main()
