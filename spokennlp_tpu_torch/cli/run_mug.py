"""MUG challenge track CLI: Track 1 (topic segmentation), Track 2
(extractive summarization) and Track 4 (keyphrase extraction), on PyTorch.

Counterpart of ``spokennlp_tpu/cli/run_mug.py`` with the same flags plus
``--device`` (default ``cuda``; raises without a card). Tracks 1 and 2 train
the PoNet token classifier on MUG meeting jsonl; Track 4 trains the BERT-CRF
tagger (projects/mug/keyphrase.py) over one id per character with BIO tags.
Each predicts, writes the official submission file and scores it with the
challenge evaluator (projects/mug/evaluate.py). Tracks 3 and 5 have their
own CLIs (cli/run_title_generation.py, cli/run_aid.py).

As in JAX: the model computes in float32; ``--init_checkpoint`` takes a
native checkpoint directory (``params.msgpack`` + ``config.json``,
models/checkpoint_io.py), whose config replaces the size flags and whose
tree is the whole model or a bare trunk (the head then keeps its fresh
init: the classifier, or the tagger's emissions and transitions); training
draws one ``np.random.default_rng(seed)`` permutation per epoch and fills
the short batch with the batch's first row; the optimizer is optax's
``adamw(lr, weight_decay=0.01)``: decay on every parameter, betas
0.9/0.999, eps 1e-8, a constant rate, no clipping. With
``ponet_mixer_impl="fused"`` in the checkpoint's config, training runs the
XLA-semantics mixer and prediction the fused mixer block (kernel 9 on the
card), once a layer a batch. Track 4's tagger trains on the training
kernels on the card (rows 10 and 11, once a layer a step) and predicts in
chunks of the batch size, filled up by repeating the chunk's rows, through
the whole-stack kernel (kernel 3, once a chunk); the CRF is plain PyTorch,
as in JAX.

    python -m spokennlp_tpu_torch.cli.run_mug --track topic_segmentation \\
        --train_file train.jsonl --eval_file dev.jsonl --output_dir out \\
        --init_checkpoint ckpt --max_seq_length 4096
    python -m spokennlp_tpu_torch.cli.run_mug --track keyphrase \\
        --train_file train.jsonl --eval_file dev.jsonl --output_dir out \\
        --vocab_file vocab.txt --max_seq_length 512
"""

from __future__ import annotations

import argparse
import json
import os


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--track", required=True,
                   choices=["topic_segmentation", "extractive_summarization",
                            "keyphrase"])
    p.add_argument("--train_file", required=True)
    p.add_argument("--eval_file", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--model_name_or_path", default=None)
    p.add_argument("--vocab_file", default=None,
                   help="WordPiece vocab for the built-in FullTokenizer")
    p.add_argument("--init_checkpoint", default=None,
                   help="native checkpoint dir (params.msgpack [+config.json])"
                        " to initialize the PoNet trunk (+head) from")
    p.add_argument("--max_seq_length", type=int, default=512)
    p.add_argument("--per_device_train_batch_size", type=int, default=4)
    p.add_argument("--num_train_epochs", type=int, default=2)
    p.add_argument("--learning_rate", type=float, default=3e-5)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--es_level", default="topic", choices=["topic", "doc"])
    p.add_argument("--annotator_strategy", default="single",
                   choices=["single", "union", "major_vote", "pool"])
    p.add_argument("--es_top_ratio", type=float, default=None)
    p.add_argument("--kpe_top_k", type=int, default=20)
    p.add_argument("--hidden_size", type=int, default=768)
    p.add_argument("--num_hidden_layers", type=int, default=12)
    p.add_argument("--num_attention_heads", type=int, default=12)
    p.add_argument("--intermediate_size", type=int, default=3072)
    p.add_argument("--device", default="cuda",
                   help="torch device to run on; cuda raises when no card is present")
    return p


def build_model(enc_cfg, ckpt_params, seed: int, device):
    """PoNetForTokenClassification on ``device``, its weights drawn from
    ``torch.Generator().manual_seed(seed)``, then the checkpoint's tree
    loaded over it: the whole model, or the trunk alone."""
    import torch

    from spokennlp_tpu_torch.models.convert import jax_params_to_state_dict
    from spokennlp_tpu_torch.models.ponet import PoNetForTokenClassification

    model = PoNetForTokenClassification(enc_cfg, generator=torch.Generator().manual_seed(seed))
    if ckpt_params is not None:
        sd = jax_params_to_state_dict(ckpt_params)
        target = model if "ponet" in ckpt_params else model.ponet
        target.load_state_dict(sd, strict=True)
    return model.to(device)


def adamw(model, learning_rate: float):
    """optax's ``adamw(lr, weight_decay=0.01)``: decay on every parameter."""
    import torch

    return torch.optim.AdamW(model.parameters(), lr=learning_rate, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=0.01)


def run_ponet_track(args, enc_cfg, ckpt_params, tokenize_fn, wcfg, eos_id, train_meetings,
                    eval_meetings, run_epochs, results, device):
    """Tracks 1 and 2: train the PoNet token classifier, predict, score.
    Returns the submission rows."""
    import torch

    from spokennlp_tpu_torch.projects.mug import data as mug_data
    from spokennlp_tpu_torch.projects.mug import evaluate as mug_eval
    from spokennlp_tpu_torch.projects.mug.topic_segmentation import (
        make_ponet_train_step,
        predict_boundaries,
        stack_eos_windows,
        window_document_eos,
    )

    bs = args.per_device_train_batch_size
    model = build_model(enc_cfg, ckpt_params, args.seed, device)
    step_fn = make_ponet_train_step(
        model, adamw(model, args.learning_rate),
        torch.Generator(device=device).manual_seed(args.seed))
    keys = ("input_ids", "attention_mask", "segment_ids", "labels")

    if args.track == "topic_segmentation":
        windows = []
        for eid, m in enumerate(train_meetings):
            parsed = mug_data.parse_topic_segmentation(m)
            sent_tokens = [tokenize_fn(s) for s in parsed["sentences"]]
            windows.extend(window_document_eos(
                sent_tokens, parsed["labels"], wcfg, eos_id, example_id=eid))
        run_epochs(step_fn, stack_eos_windows(windows), keys)

        parsed_eval = [mug_data.parse_topic_segmentation(m) for m in eval_meetings]
        boundaries = predict_boundaries(model, parsed_eval, tokenize_fn, wcfg, eos_id,
                                        batch_size=bs)
        sub = mug_data.topic_segmentation_submission(
            [m.get("meeting_key", "") for m in eval_meetings], boundaries)
        results["metrics"] = mug_eval.topic_segment_evaluate(eval_meetings, sub)
        return sub

    from spokennlp_tpu_torch.projects.mug.extractive_summarization import (
        evaluate_es_rouge,
        featurize_es_examples,
        predict_key_sentences,
    )

    _, train_windows = featurize_es_examples(
        train_meetings, tokenize_fn, wcfg, eos_id, level=args.es_level,
        annotator_strategy=args.annotator_strategy)
    run_epochs(step_fn, stack_eos_windows(train_windows), keys)

    examples, eval_windows = featurize_es_examples(
        eval_meetings, tokenize_fn, wcfg, eos_id, level=args.es_level,
        annotator_strategy=args.annotator_strategy)
    preds = predict_key_sentences(model, examples, eval_windows, batch_size=bs,
                                  top_ratio=args.es_top_ratio)
    results["metrics"] = evaluate_es_rouge(examples, preds)
    # submission in the official format: per-topic key sentences (topic id
    # = segment-end sentence id, matching the label file) plus the
    # doc-level union, scoreable by run_mug_evaluate
    mkeys = [m.get("meeting_key", "") for m in eval_meetings]
    by_meeting = {k: {"topics": [], "doc": []} for k in mkeys}
    for ex, ids in zip(examples, preds):
        off0, off1 = ex.get("topic_span", (0, len(ex["sentences"])))
        glob = sorted(int(i + off0) for i in ids)
        d = by_meeting[ex["meeting_key"]]
        d["topics"].append({"id": int(off1), "key_sentence": glob})
        d["doc"].extend(glob)
    sub = mug_data.extractive_summarization_submission(
        mkeys, [by_meeting[k]["topics"] for k in mkeys],
        [sorted(set(by_meeting[k]["doc"])) for k in mkeys])
    if args.es_level == "topic" and args.annotator_strategy != "pool":
        try:
            results["official"] = mug_eval.extractive_summarization_evaluate(
                eval_meetings, sub)
        except (KeyError, AssertionError) as e:
            # the label file lacks doc-level key_sentence candidates (or
            # topic counts mismatch); the rouge metrics above still hold
            results["official_error"] = f"{type(e).__name__}: {e}"
    return sub


def run_keyphrase(args, enc_cfg, ckpt_params, tokenize_fn, special, train_meetings,
                  eval_meetings, run_epochs, results, device):
    """Track 4: train the BERT-CRF tagger over char ids, tag the eval
    sentences in chunks of the batch size, rank each meeting's spans, score.
    Returns the submission rows."""
    import numpy as np
    import torch

    from spokennlp_tpu_torch.projects.mug import data as mug_data
    from spokennlp_tpu_torch.projects.mug import evaluate as mug_eval
    from spokennlp_tpu_torch.projects.mug.keyphrase import (
        build_tagger,
        decode_tags,
        extract_keyphrases,
        featurize_kpe,
        make_kpe_train_step,
    )

    bs = args.per_device_train_batch_size
    L = args.max_seq_length
    model = build_tagger(enc_cfg, ckpt_params, args.seed, device)
    step_fn = make_kpe_train_step(model, adamw(model, args.learning_rate),
                                  torch.Generator(device=device).manual_seed(args.seed))
    keys = ("input_ids", "attention_mask", "tags")
    train_rows = featurize_kpe(train_meetings, tokenize_fn, special["pad"], L, with_tags=True)
    run_epochs(step_fn, {k: np.stack([r[k] for r in train_rows]) for k in keys}, keys)

    eval_rows = featurize_kpe(eval_meetings, tokenize_fn, special["pad"], L, with_tags=False)
    per_meeting_tokens, per_meeting_tags, per_meeting_masks = {}, {}, {}
    for s in range(0, len(eval_rows), bs):
        chunk = eval_rows[s : s + bs]
        real = len(chunk)
        while len(chunk) < bs:
            chunk = chunk + chunk[: bs - len(chunk)]
        tags = decode_tags(model, np.stack([r["input_ids"] for r in chunk]),
                           np.stack([r["attention_mask"] for r in chunk]))
        for r, t in zip(chunk[:real], tags[:real]):
            mk = r["meeting_key"]
            per_meeting_tokens.setdefault(mk, []).append(r["tokens"])
            per_meeting_tags.setdefault(mk, []).append(t.tolist())
            per_meeting_masks.setdefault(mk, []).append(r["attention_mask"].tolist())
    mkeys = list(per_meeting_tokens)
    kws = [extract_keyphrases(per_meeting_tokens[k], per_meeting_tags[k],
                              per_meeting_masks[k], top_k=args.kpe_top_k) for k in mkeys]
    sub = mug_data.keyphrase_submission(mkeys, kws)
    by_key = {m.get("meeting_key", ""): m for m in eval_meetings}
    results["metrics"] = mug_eval.keyphrase_extraction_evaluate(
        [by_key[k] for k in mkeys], sub)  # label samples in the submission's order
    return sub


def main(argv=None):
    args = make_parser().parse_args(argv)
    os.makedirs(args.output_dir, exist_ok=True)

    import numpy as np
    import torch

    from spokennlp_tpu_torch.cli import common
    from spokennlp_tpu_torch.cli.run_inference import resolve_device
    from spokennlp_tpu_torch.configs import EncoderConfig, WindowingConfig
    from spokennlp_tpu_torch.projects.mug import data as mug_data

    device = resolve_device(args.device)
    ns = argparse.Namespace(model_name_or_path=args.model_name_or_path,
                            vocab_file=args.vocab_file)
    tokenize_fn, special = common.resolve_tokenizer(ns)
    eos_id = special.get("sep", 102)

    ckpt_params = ckpt_cfg = None
    if args.init_checkpoint:
        from spokennlp_tpu_torch.models import checkpoint_io

        ckpt_params, ckpt_cfg = checkpoint_io.load_checkpoint(args.init_checkpoint)

    enc_cfg = ckpt_cfg if ckpt_cfg is not None else EncoderConfig(
        vocab_size=special["vocab_size"],
        hidden_size=args.hidden_size,
        num_layers=args.num_hidden_layers,
        num_heads=args.num_attention_heads,
        intermediate_size=args.intermediate_size,
        max_position_embeddings=max(args.max_seq_length, 512),
        pad_token_id=special["pad"],
        add_pooler=False,
    )
    wcfg = WindowingConfig(
        max_seq_length=args.max_seq_length,
        cls_token_id=special["cls"],
        pad_token_id=special["pad"],
        bos_token_id=special["bos"],
    )

    train_meetings = mug_data.read_jsonl(args.train_file)
    eval_meetings = mug_data.read_jsonl(args.eval_file)
    data_rng = np.random.default_rng(args.seed)
    bs = args.per_device_train_batch_size
    results = {}

    def run_epochs(step_fn, batch_arrays, keys):
        n = batch_arrays[keys[0]].shape[0]
        for _ in range(args.num_train_epochs):
            order = data_rng.permutation(n)
            for s in range(0, n, bs):
                take = order[s : s + bs].tolist()
                while len(take) < bs:
                    take.append(take[0])
                batch = {k: torch.from_numpy(batch_arrays[k][take]).to(device) for k in keys}
                metrics = step_fn(batch)
            results.setdefault("train_loss", []).append(float(metrics["loss"]))

    if args.track == "keyphrase":
        sub = run_keyphrase(args, enc_cfg, ckpt_params, tokenize_fn, special, train_meetings,
                            eval_meetings, run_epochs, results, device)
    else:
        sub = run_ponet_track(args, enc_cfg, ckpt_params, tokenize_fn, wcfg, eos_id,
                              train_meetings, eval_meetings, run_epochs, results, device)

    with open(os.path.join(args.output_dir, "submission.jsonl"), "w") as f:
        for row in sub:
            f.write(json.dumps(row, ensure_ascii=False) + "\n")
    with open(os.path.join(args.output_dir, f"{args.track}_results.json"), "w") as f:
        json.dump(results, f, indent=2, default=float)
    print(json.dumps(results.get("metrics", {}), indent=2, default=float))
    return results


if __name__ == "__main__":
    main()
