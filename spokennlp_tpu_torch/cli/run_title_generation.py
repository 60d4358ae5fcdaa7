"""MUG Track 3: topic title generation CLI, on PyTorch.

Counterpart of ``spokennlp_tpu/cli/run_title_generation.py`` (the
reference's PALM 2.0 script, alimeeting4mug/src/topic_title_generation/
palm_subtitle_generation.py) with the same flags plus ``--device`` (default
``cuda``; raises without a card): trains an encoder-decoder on (topic text
-> title) pairs with the noam learning rate, decodes every epoch with beam
search, reports multi-reference rouge (the mean over the annotators'
titles) and writes the Track 3 submission for the eval split.

``--model_arch seq2seq`` is the compact post-norm encoder-decoder
(models/seq2seq.py), ``palm`` the PALM 2.0 architecture with the
pointer-generator (models/palm.py); ``--palm_checkpoint`` reads a ModelScope
palm_v2 ``pytorch_model.bin`` (or a directory holding it) through
``hf_convert.palm_to_params``. As in JAX: the tokenizer is the
``--model_name_or_path`` directory's through ``transformers`` where that
package is installed and reads it, else a character vocabulary built from
the corpus (ids from 4; pad 0, bos 1, eos 2); the optimizer is optax's
``adam`` on ``noam_schedule(hidden_size, noam_factor, warmup_steps)`` (no
decay), after global-norm clipping when ``--clip_grad_norm`` > 0; each
epoch draws one ``np.random.default_rng(seed)`` permutation and fills the
short batch with the batch's first pair. On the card the encoder trains on
the training kernels (rows 10 and 11, once a layer a step) and, at every
decode step, runs the whole-stack kernel (kernel 3) over the B * num_beams
rows; the decoders are plain PyTorch, as in JAX.

    python -m spokennlp_tpu_torch.cli.run_title_generation --train_file train.jsonl \\
        --eval_file dev.jsonl --output_dir out --model_arch palm
"""

from __future__ import annotations

import argparse
import json
import os


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--train_file", required=True)
    p.add_argument("--eval_file", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--model_name_or_path", default=None)
    p.add_argument("--max_source_length", type=int, default=512)
    p.add_argument("--max_target_length", type=int, default=32)
    p.add_argument("--per_device_train_batch_size", type=int, default=4)
    p.add_argument("--num_train_epochs", type=int, default=3)
    p.add_argument("--num_beams", type=int, default=4)
    p.add_argument("--noam_factor", type=float, default=1.0)
    p.add_argument("--warmup_steps", type=int, default=100)
    p.add_argument("--clip_grad_norm", type=float, default=0.0,
                   help="global-norm gradient clipping (0 = off, the "
                   "reference PALM recipe's default)")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--hidden_size", type=int, default=256)
    p.add_argument("--num_hidden_layers", type=int, default=4)
    p.add_argument("--num_decoder_layers", type=int, default=4)
    p.add_argument("--num_attention_heads", type=int, default=4)
    p.add_argument("--intermediate_size", type=int, default=1024)
    p.add_argument(
        "--model_arch", default="seq2seq", choices=["seq2seq", "palm"],
        help="palm = the PALM 2.0 architecture (pre-norm OpenNMT decoder + "
        "pointer-generator, models/palm.py); seq2seq = the compact "
        "post-norm encoder-decoder")
    p.add_argument(
        "--palm_checkpoint", default=None,
        help="path to a ModelScope palm_v2 torch checkpoint "
        "(pytorch_model.bin or dir containing it) converted via "
        "hf_convert.palm_to_params")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on; cuda raises when no card is present")
    return p


def make_tokenizer(model_name_or_path):
    """(encode, decode, vocab_size or None, pad, bos, eos, chars): the
    directory's tokenizer through ``transformers`` where it loads, else the
    corpus's character vocabulary (``chars``, filled by ``encode``; the
    size is known after the corpus scan)."""
    tok = None
    if model_name_or_path and os.path.isdir(model_name_or_path):
        try:
            from transformers import AutoTokenizer

            tok = AutoTokenizer.from_pretrained(model_name_or_path)
        except Exception:  # no transformers, or a directory it cannot read
            tok = None
    if tok is not None:
        encode = lambda s: tok(s, add_special_tokens=False)["input_ids"]
        decode = lambda ids: tok.decode(ids, skip_special_tokens=True)
        return (encode, decode, len(tok), tok.pad_token_id or 0, tok.cls_token_id or 101,
                tok.sep_token_id or 102, None)
    # a character vocabulary built from the corpus (CJK meeting text)
    chars = {}

    def encode(s):
        return [chars.setdefault(c, len(chars) + 4) for c in s]

    inv = {}

    def decode(ids):
        if not inv or len(inv) != len(chars):
            inv.clear()
            inv.update({v: k for k, v in chars.items()})
        return "".join(inv.get(int(i), "") for i in ids if int(i) > 3)

    return encode, decode, None, 0, 1, 2, chars


def pairs_from(path, require_refs):
    """All topics (for decoding and the submission) or only the topics with
    reference titles (for training). Keeps the topic's segment-end sentence
    id, so the submission aligns with the label file."""
    from spokennlp_tpu_torch.projects.mug.data import parse_title_generation, read_jsonl

    out = []
    for meeting in read_jsonl(path):
        for t in parse_title_generation(meeting):
            refs = [x for x in t["titles"] if x]
            if not t["source"]:
                continue
            if require_refs and not refs:
                continue
            out.append({"source": t["source"], "titles": refs, "meeting_key": t["meeting_key"],
                        "segment_id": int(t["topic_span"][1])})
    return out


def featurize(rows, encode, S: int, T: int, pad_id: int, bos_id: int, eos_id: int):
    """Source ids and mask (n, S); decoder input [BOS] title[:-1], its mask
    and labels title + [EOS] (n, T), from each row's first title."""
    import numpy as np

    n = len(rows)
    ids = np.zeros((n, S), np.int32)
    am = np.zeros((n, S), np.int32)
    dec_in = np.full((n, T), pad_id, np.int32)
    dec_am = np.zeros((n, T), np.int32)
    labels = np.full((n, T), -100, np.int32)
    for i, r in enumerate(rows):
        src = encode(r["source"])[:S]
        ids[i, : len(src)] = src
        am[i, : len(src)] = 1
        ref = r["titles"][0] if r["titles"] else ""
        tgt = encode(ref)[: T - 1] + [eos_id]
        dec_in[i, 0] = bos_id
        dec_in[i, 1 : len(tgt)] = tgt[:-1]
        dec_am[i, : len(tgt)] = 1
        labels[i, : len(tgt)] = tgt
    return {"input_ids": ids, "attention_mask": am, "decoder_input_ids": dec_in,
            "decoder_attention_mask": dec_am, "labels": labels}


def build_model(args, vocab_size: int, pad_id: int, bos_id: int, eos_id: int, device):
    """(model, loss_fn(model, batch, generator), decode_fn) for
    ``--model_arch``, weights drawn from ``torch.Generator().manual_seed(
    seed)`` (or ``--palm_checkpoint``'s), on ``device``."""
    import torch

    from spokennlp_tpu_torch.configs import EncoderConfig

    S, T = args.max_source_length, args.max_target_length
    enc_cfg = EncoderConfig(
        vocab_size=vocab_size, hidden_size=args.hidden_size,
        num_layers=args.num_hidden_layers, num_heads=args.num_attention_heads,
        intermediate_size=args.intermediate_size,
        max_position_embeddings=max(S, 512), add_pooler=False, pad_token_id=pad_id,
    )
    dec = dict(vocab_size=vocab_size, hidden_size=args.hidden_size,
               num_decoder_layers=args.num_decoder_layers, num_heads=args.num_attention_heads,
               intermediate_size=args.intermediate_size, max_target_length=T,
               bos_token_id=bos_id, eos_token_id=eos_id, pad_token_id=pad_id)
    gen = torch.Generator().manual_seed(args.seed)
    if args.model_arch == "palm":
        import dataclasses

        from spokennlp_tpu_torch.models.palm import (
            PalmConfig, PalmModel, palm_beam_decode, palm_loss,
        )

        params = None
        if args.palm_checkpoint:
            from spokennlp_tpu_torch.models import hf_convert

            ckpt = args.palm_checkpoint
            if os.path.isdir(ckpt):
                ckpt = os.path.join(ckpt, "pytorch_model.bin")
            sd = {k: v.numpy() for k, v in
                  torch.load(ckpt, map_location="cpu", weights_only=True).items()}
            params = hf_convert.palm_to_params(sd, enc_cfg, args.num_decoder_layers)
            # the checkpoint's tables replace the fresh ones whole, as JAX's
            # params do: their sizes set the vocabulary and the positions
            emb = {k: v["embedding"].shape[0] for k, v in params["encoder"]["embeddings"].items()
                   if "embedding" in v}
            enc_cfg = dataclasses.replace(
                enc_cfg, vocab_size=emb["word_embeddings"],
                max_position_embeddings=emb["position_embeddings"],
                type_vocab_size=emb.get("token_type_embeddings", 0))
            dec["vocab_size"] = params["dec_embed"]["embedding"].shape[0]
        model = PalmModel(enc_cfg, PalmConfig(**dec), generator=gen)
        loss_fn, decode_fn = palm_loss, palm_beam_decode
        if params is not None:
            from spokennlp_tpu_torch.models.convert import jax_params_to_state_dict

            model.load_state_dict(jax_params_to_state_dict(params), strict=True)
            print(f"loaded PALM checkpoint from {args.palm_checkpoint}")
    else:
        from spokennlp_tpu_torch.models.seq2seq import (
            Seq2SeqConfig, Seq2SeqModel, beam_decode, seq2seq_loss,
        )

        model = Seq2SeqModel(enc_cfg, Seq2SeqConfig(**dec), generator=gen)
        loss_fn, decode_fn = seq2seq_loss, beam_decode
    return model.to(device), loss_fn, decode_fn


def make_title_train_step(model, loss_fn, args, generator=None):
    """``step(batch) -> loss``: Adam (optax's defaults, no decay) at the noam
    rate of the step count, after global-norm clipping when
    ``args.clip_grad_norm`` > 0. ``step.count`` is the number of steps taken."""
    import torch

    from spokennlp_tpu_torch.train.optim import clip_by_global_norm_, noam_schedule

    schedule = noam_schedule(args.hidden_size, args.noam_factor, args.warmup_steps)
    params = [p for p in model.parameters() if p.requires_grad]
    optimizer = torch.optim.Adam(params, lr=schedule(0), betas=(0.9, 0.999), eps=1e-8)

    def step(batch):
        model.train()
        loss = loss_fn(model, batch, generator=generator)
        grads = torch.autograd.grad(loss, params)
        if args.clip_grad_norm > 0:
            clip_by_global_norm_(grads, args.clip_grad_norm)
        for p, g in zip(params, grads):
            p.grad = g
        for group in optimizer.param_groups:
            group["lr"] = schedule(step.count)
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)
        step.count += 1
        return loss.detach()

    step.count = 0
    return step


def main(argv=None):
    args = make_parser().parse_args(argv)
    os.makedirs(args.output_dir, exist_ok=True)

    import numpy as np
    import torch

    from spokennlp_tpu_torch.cli.run_inference import resolve_device
    from spokennlp_tpu_torch.eval.rouge import rouge_scores
    from spokennlp_tpu_torch.projects.mug.data import title_generation_submission

    device = resolve_device(args.device)
    encode, decode, vocab_size, pad_id, bos_id, eos_id, chars = make_tokenizer(
        args.model_name_or_path)
    train_pairs = pairs_from(args.train_file, require_refs=True)
    eval_pairs = pairs_from(args.eval_file, require_refs=False)
    assert train_pairs, "no (topic, title) training pairs"
    if chars is not None:  # the character vocabulary over everything, before sizing the model
        for r in train_pairs + eval_pairs:
            encode(r["source"])
            for t in r["titles"]:
                encode(t)
        vocab_size = len(chars) + 4

    S, T = args.max_source_length, args.max_target_length
    model, loss_fn, decode_fn = build_model(args, vocab_size, pad_id, bos_id, eos_id, device)
    step_fn = make_title_train_step(model, loss_fn, args,
                                    torch.Generator(device=device).manual_seed(args.seed))
    feats = featurize(train_pairs, encode, S, T, pad_id, bos_id, eos_id)
    efeats = featurize(eval_pairs, encode, S, T, pad_id, bos_id, eos_id)
    data_rng = np.random.default_rng(args.seed)
    bs = args.per_device_train_batch_size
    n = len(train_pairs)

    def decode_eval():
        hyps = []
        for s in range(0, len(eval_pairs), bs):
            sl = slice(s, min(s + bs, len(eval_pairs)))
            gen = decode_fn(model, torch.from_numpy(efeats["input_ids"][sl]).to(device),
                            torch.from_numpy(efeats["attention_mask"][sl]).to(device),
                            num_beams=args.num_beams, max_len=T)
            for row in gen.cpu().numpy():
                toks = [int(t) for t in row[1:]]
                if eos_id in toks:
                    toks = toks[: toks.index(eos_id)]
                hyps.append(decode(toks))
        return hyps

    def rouge_eval(hyps):
        # multi-reference rouge averaged over the annotators' candidates;
        # only topics with references count (a test split may have none)
        r1 = rl = m = 0.0
        for hyp, r in zip(hyps, eval_pairs):
            if not r["titles"]:
                continue
            scores = [rouge_scores([hyp], [ref]) for ref in r["titles"]]
            r1 += float(np.mean([sc["rouge-1"]["f"] for sc in scores]))
            rl += float(np.mean([sc["rouge-l"]["f"] for sc in scores]))
            m += 1
        m = m or 1
        return {"rouge1": 100 * r1 / m, "rougeL": 100 * rl / m}

    history, hyps = [], []
    for epoch in range(1, args.num_train_epochs + 1):
        order = data_rng.permutation(n)
        losses = []
        for s in range(0, n, bs):
            take = order[s : s + bs].tolist()
            while len(take) < bs:
                take.append(take[0])
            batch = {k: torch.from_numpy(v[take]).to(device) for k, v in feats.items()}
            losses.append(float(step_fn(batch)))
        hyps = decode_eval()
        row = {"epoch": epoch, "train_loss": float(np.mean(losses)), **rouge_eval(hyps)}
        history.append(row)
        print(json.dumps(row))
    if not history:  # a decode-only call (--num_train_epochs 0)
        hyps = decode_eval()
        history.append({"epoch": 0, **rouge_eval(hyps)})

    # the Track 3 submission for the eval split; a topic's id is its
    # segment-end sentence id, as in the label file
    per_meeting = {}
    for hyp, r in zip(hyps, eval_pairs):
        per_meeting.setdefault(r["meeting_key"], []).append({"id": r["segment_id"], "title": hyp})
    sub = title_generation_submission(list(per_meeting), list(per_meeting.values()))
    with open(os.path.join(args.output_dir, "track3_submission.json"), "w") as f:
        json.dump(sub, f, ensure_ascii=False, indent=2)
    with open(os.path.join(args.output_dir, "ttg_results.json"), "w") as f:
        json.dump(history, f, indent=2)
    return {"history": history, "final": history[-1]}


if __name__ == "__main__":
    main()
