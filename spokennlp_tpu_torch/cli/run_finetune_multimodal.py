"""MMVTS multimodal fine-tuning CLI, on PyTorch.

Counterpart of ``spokennlp_tpu/cli/run_finetune_multimodal.py`` (the
reference's run_finetune_multimodal.sh -> main_multimodal.py) with the same
flags plus ``--device`` (``cuda`` by default; it raises when no card is
present): avlecture / clvts clip transcripts are windowed like emnlp2023
sentences, cached per-clip ``.npy`` features (``--vis_feature_dir``,
``--audio_feature_dir``: one ``<lecture>.npy`` of (n_clips, H) a video;
zeros where a file is missing) are aligned onto the (B, K) clip grid, the
fusion model trains with the composite loss (weighted ts CE, modality
InfoNCE, topic CL matrix / list, MoE balance), and eval reports the
time-aware video metrics (clip-F1, 1-Pk / 1-WD, bs@k, mIoU, F1 tolerance) in
``<output_dir>/mm_results.json``.

As in JAX: the optimizer is ``make_optimizer(tcfg, total_steps=1000)``
(AdamW, clipping, the schedule over 1000 steps, accumulation), or with
``--cross_encoder_lr`` Adam(W) groups by path substring (``cross_encoder``);
a ``--model_name_or_path`` trunk is merged leaf by leaf into the text
encoder; a short batch is filled with its first row (training) or its first
rows again (eval); a corpus without ``clip_end_seconds`` is scored on a 10 s
clip grid. On the card the dense trunk trains on rows 10 and 11 and
evaluates batches of at most 32 on kernel 3; ``--attention_type
sliding_window`` trains on rows 12 and 11 and evaluates on kernels 7 and 2.

Under ``torchrun --nproc_per_node=N`` (or with ``--jax_distributed``) it
runs on JAX's (N // mp, mp) mesh of ``--model_parallel_size`` mp, one
process a card: the global batch is ``--per_device_train_batch_size`` x
N // mp, as JAX's ``bs = per_device_batch_size * dp``; each data rank
trains on its rows with the loss over the global batch (projects/mmvts.py);
the trunk's and the fusion layers' heads and MLP columns and the MoE's
experts are sharded over the mp ranks of a data line (parallel/mesh.py).
Every rank scores every eval window at the global batch (the MoE's capacity
follows the batch, so the predictions are one process's at that batch);
rank 0 writes ``mm_results.json``.

    python -m spokennlp_tpu_torch.cli.run_finetune_multimodal --dataset_name clvts \\
        --data_dir <clvts dir> --output_dir out --do_train --do_eval \\
        --cross_encoder_type ma_moe --moe_impl dispatch --do_modality_cl \\
        --align_pairs tv,av,at
"""

from __future__ import annotations

import argparse
import json
import os


def make_parser() -> argparse.ArgumentParser:
    from spokennlp_tpu_torch.cli import common

    p = argparse.ArgumentParser()
    common.add_model_args(p)
    common.add_data_args(p)
    common.add_training_args(p)
    g = p.add_argument_group("multimodal")
    g.add_argument("--fuse_type", default="cat",
                   choices=["cat", "mean", "max", "text_only", "vis_only",
                            "audio_only", "cat_a_t", "cat_a_v", "cat_t_v"])
    g.add_argument("--cross_encoder_type", default="ma",
                   choices=["ma", "ca", "ma_moe", "ca_moe", "none"])
    g.add_argument("--projector_type", default="linear", choices=["linear", "transformer"])
    g.add_argument("--predictor_hybrid_weight_type", default="p", choices=["p", "l"])
    g.add_argument("--predictor_hybrid_pooling", default="mean", choices=["mean", "max"])
    g.add_argument("--out_modal_prob", action="store_true",
                   help="with a cat fuse, also emit per-modality logit splits")
    g.add_argument("--cross_moe_share_in_layers", action="store_true")
    g.add_argument("--moe_impl", default="dense", choices=["dense", "dispatch"],
                   help="dispatch = GShard-style capacity dispatch (tokens over "
                   "capacity drop)")
    g.add_argument("--moe_capacity_factor", type=float, default=1.25)
    g.add_argument("--moe_num_experts", type=int, default=4)
    g.add_argument("--moe_top_k", type=int, default=2)
    g.add_argument("--no_cross_moe_residual", action="store_true")
    g.add_argument("--predictor_type", default="linear",
                   choices=["linear", "transformer", "hybrid"])
    g.add_argument("--mm_hidden_size", type=int, default=128)
    g.add_argument("--num_cross_encoder_layers", type=int, default=2)
    g.add_argument("--cross_encoder_lr", type=float, default=None,
                   help="per-module LR for the cross-encoder "
                   "(reference main_multimodal.py:695-705)")
    g.add_argument("--weight_label_zero_mm", type=float, default=0.7)
    g.add_argument("--do_modality_cl", action="store_true")
    g.add_argument("--align_pairs", default="tv",
                   help="comma list from {av,at,tv}, each optionally weighted 'tv=0.33' "
                   "(default weight 0.33 = the reference's align_*_weight)")
    g.add_argument("--modality_cl_lw", type=float, default=1.0,
                   help="global modality-CL weight (reference modality_cl_lw)")
    g.add_argument("--do_topic_mm_cl", action="store_true")
    g.add_argument("--topic_cl_type", default="matrix", choices=["matrix", "list"])
    g.add_argument("--topic_cl_fct", default="simcse", choices=["simcse", "ce"])
    g.add_argument("--topic_cl_choice", default="random", choices=["random", "near"])
    g.add_argument("--topic_cl_pos_k", type=int, default=1)
    g.add_argument("--topic_cl_neg_k", type=int, default=3)
    g.add_argument("--vis_feature_dir", default=None)
    g.add_argument("--audio_feature_dir", default=None)
    g.add_argument("--vis_hidden_size", type=int, default=512)
    g.add_argument("--audio_hidden_size", type=int, default=768)
    g.add_argument("--max_clips_per_window", type=int, default=64)
    g.add_argument("--do_pretrain", action="store_true",
                   help="modality-alignment pretraining objective only "
                   "(reference: mmvts/src/pretrain.py)")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on; cuda raises when no card is present")
    return p


def parse_align_pairs(spec: str):
    """"tv,av=0.5" -> {"tv": 0.33, "av": 0.5} (0.33: the reference's
    align_*_weight)."""
    pairs = {}
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        if "=" in entry:
            k, w = entry.split("=", 1)
            pairs[k] = float(w)
        else:
            pairs[entry] = 0.33
    return pairs


def main(argv=None):
    from spokennlp_tpu_torch.cli import common
    from spokennlp_tpu_torch.parallel import dist

    args = make_parser().parse_args(argv)
    os.makedirs(args.output_dir, exist_ok=True)
    joined = common.maybe_init_distributed(args)
    try:
        return run(args)
    finally:
        if joined:
            dist.destroy()


def run(args):
    """One MMVTS run of the parsed flags; returns its results."""
    import dataclasses as dc

    import numpy as np
    import torch

    from spokennlp_tpu_torch.cli import common
    from spokennlp_tpu_torch.cli.run_inference import resolve_device
    from spokennlp_tpu_torch.data import corpora
    from spokennlp_tpu_torch.eval.video_metrics import evaluate_video_corpus
    from spokennlp_tpu_torch.models.multimodal import MultimodalConfig
    from spokennlp_tpu_torch.objectives.mmvts_losses import build_topic_cl_list_indices
    from spokennlp_tpu_torch.parallel import dist
    from spokennlp_tpu_torch.parallel import mesh as mesh_lib
    from spokennlp_tpu_torch.projects import mmvts
    from spokennlp_tpu_torch.train import optim
    from spokennlp_tpu_torch.train.train_step import batch_to_device

    device = resolve_device(args.device)
    mesh_lib.check_model_parallel(args.model_parallel_size, dist.world_size())
    tokenize_fn, special = common.resolve_tokenizer(args)
    enc_cfg, _task, wcfg, tcfg = common.build_configs(args, special)

    # a pretrained text trunk (the reference's TextEncoder wraps a BERT /
    # Longformer checkpoint, text_encoder.py:4-89)
    pretrained = common.maybe_load_pretrained(args, enc_cfg)
    trunk = None
    if pretrained is not None:
        loaded_cfg, trunk = pretrained
        trunk, loaded_cfg = common.resize_word_embeddings(trunk, loaded_cfg,
                                                          special["vocab_size"], seed=tcfg.seed)
        enc_cfg = dc.replace(loaded_cfg, add_pooler=False, attention_type=enc_cfg.attention_type)

    mm_cfg = MultimodalConfig(
        hidden_size=args.mm_hidden_size,
        text_hidden_size=enc_cfg.hidden_size,
        vis_hidden_size=args.vis_hidden_size,
        audio_hidden_size=args.audio_hidden_size,
        projector_type=args.projector_type,
        cross_encoder_type=args.cross_encoder_type,
        num_cross_encoder_layers=args.num_cross_encoder_layers,
        fuse_type=args.fuse_type,
        predictor_type=args.predictor_type,
        predictor_hybrid_weight_type=args.predictor_hybrid_weight_type,
        predictor_hybrid_pooling=args.predictor_hybrid_pooling,
        out_modal_prob=args.out_modal_prob,
        moe_share_in_layers=args.cross_moe_share_in_layers,
        moe_impl=args.moe_impl,
        moe_capacity_factor=args.moe_capacity_factor,
        moe_num_experts=args.moe_num_experts,
        moe_top_k=args.moe_top_k,
        moe_residual=not args.no_cross_moe_residual,
    )
    K = args.max_clips_per_window

    def load_feats(lecture, n_clips):
        feats = {}
        for mod, d, width in (("vis", args.vis_feature_dir, args.vis_hidden_size),
                              ("audio", args.audio_feature_dir, args.audio_hidden_size)):
            if mod not in mm_cfg.modalities:
                continue
            path = d and os.path.join(d, f"{lecture}.npy")
            if path and os.path.exists(path):
                feats[mod] = np.load(path)[:n_clips].astype(np.float32)
            else:
                feats[mod] = np.zeros((n_clips, width), np.float32)
        return feats

    splits = corpora.load_dataset_splits(args.dataset_name, args.data_dir)
    windows, clip_times = {}, {}
    for split, examples in splits.items():
        limit = {"train": args.max_train_samples, "validation": args.max_eval_samples,
                 "test": args.max_predict_samples}[split]
        if limit:
            examples = examples[:limit]
        rows = []
        by_id = {e["example_id"]: e for e in examples}
        for ex in corpora.tokenize_examples(examples, tokenize_fn):
            lecture = by_id.get(ex["example_id"], {}).get("lecture", str(ex["example_id"]))
            inv_labels = [1 if lab == 0 else 0 for lab in ex["labels"]]  # to EOT=1
            rows.extend(mmvts.featurize_video(
                ex["sent_token_ids"], inv_labels, load_feats(lecture, len(ex["labels"])),
                wcfg, example_id=ex["example_id"], max_clips_per_window=K))
        windows[split] = rows
        # per-clip end seconds for the time-aware eval (a 10 s grid without)
        for e in examples:
            secs = e.get("clip_end_seconds")
            clip_times[e["example_id"]] = [float(v) for v in secs] if secs else None

    train_rows = windows.get("train", [])
    if not train_rows:
        raise ValueError("no training windows")
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    model = mmvts.MMVTSModel(enc_cfg, mm_cfg, dtype,
                             generator=torch.Generator().manual_seed(tcfg.seed))
    if trunk is not None:
        common.merge_trunk(model.text_encoder, trunk, keys=("text_encoder", "encoder"))
    model = common.place_on_mesh(model.to(device), args.model_parallel_size)
    mesh = dist.mesh()

    if args.cross_encoder_lr:
        optimizer = optim.make_module_lr_optimizer(
            model.named_parameters(), args.learning_rate,
            {"cross_encoder": args.cross_encoder_lr}, weight_decay=args.weight_decay)
    else:
        optimizer = optim.make_optimizer(model, tcfg, total_steps=1000)

    align_pairs = parse_align_pairs(args.align_pairs)
    if args.do_pretrain:
        step_fn = mmvts.make_mmvts_pretrain_step(model, optimizer, align_pairs, args.cl_temp,
                                                 seed=tcfg.seed)
    else:
        step_fn = mmvts.make_mmvts_train_step(model, optimizer, dict(
            weight_label_zero=args.weight_label_zero_mm,
            do_modality_cl=args.do_modality_cl,
            align_pairs=align_pairs,
            modality_cl_lw=args.modality_cl_lw,
            cl_temp=args.cl_temp,
            do_topic_mm_cl=args.do_topic_mm_cl,
            topic_cl_type=args.topic_cl_type,
            topic_cl_fct=args.topic_cl_fct,
        ), seed=tcfg.seed)

    ex0 = train_rows[0]
    batch_keys = ["input_ids", "attention_mask", "clip_positions", "clip_mask",
                  "clip_labels"] + [k for k in ex0 if k.endswith("_feats")]
    bs = max(tcfg.per_device_batch_size * mesh.data_size, mesh.data_size)
    data_rng = np.random.default_rng(tcfg.seed)

    history = []
    if args.do_train:
        for epoch in range(int(args.num_train_epochs)):
            order = data_rng.permutation(len(train_rows))
            for s in range(0, len(order), bs):
                take = order[s:s + bs].tolist()
                while len(take) < bs:
                    take.append(take[0])
                chunk = [train_rows[i] for i in take]
                batch = {k: np.stack([c[k] for c in chunk]) for k in batch_keys}
                if args.do_topic_mm_cl and args.topic_cl_type == "list":
                    idx = build_topic_cl_list_indices(
                        batch["clip_labels"], batch["clip_mask"], args.topic_cl_pos_k,
                        args.topic_cl_neg_k, args.topic_cl_choice, data_rng)
                    batch.update({f"topic_cl_{k}": v for k, v in idx.items()})
                batch = mesh_lib.shard_batch(batch, mesh.data_index, mesh.data_size)
                metrics = step_fn(batch_to_device(batch, device))
            history.append({"epoch": epoch + 1, **{k: float(v) for k, v in metrics.items()}})
            if dist.rank() == 0:
                print(json.dumps(history[-1]))

    results = {"history": history}
    eval_rows = windows.get("validation") or windows.get("test") or []
    if (args.do_eval or args.do_predict) and eval_rows and not args.do_pretrain:
        model.eval()
        per_video = {}
        with torch.no_grad():
            for s in range(0, len(eval_rows), bs):
                chunk = eval_rows[s:s + bs]
                real = len(chunk)
                while len(chunk) < bs:
                    chunk = chunk + chunk[:bs - len(chunk)]
                b = batch_to_device({k: np.stack([c[k] for c in chunk]) for k in batch_keys},
                                    device)
                out = model(b["input_ids"], b["attention_mask"], b["clip_positions"],
                            b["clip_mask"], vis_feats=b.get("vis_feats"),
                            audio_feats=b.get("audio_feats"))
                preds = torch.argmax(out["logits"], -1).cpu().numpy()
                for i in range(real):
                    row = chunk[i]
                    d = per_video.setdefault(row["example_id"], {"labels": {}, "preds": {}})
                    for k in range(K):
                        if row["clip_mask"][k]:
                            cid = int(row["clip_ids"][k])
                            d["labels"][cid] = int(row["clip_labels"][k])
                            d["preds"][cid] = int(preds[i, k])
        examples = []
        for vid, d in per_video.items():
            cids = sorted(d["labels"])
            times = clip_times.get(vid)
            examples.append({
                "example_id": vid,
                "labels": [d["labels"][c] for c in cids],
                "preds": [d["preds"][c] for c in cids],
                "clip_end_seconds": ([times[c] for c in cids]
                                     if times and max(cids) < len(times)
                                     else [float(c + 1) * 10.0 for c in cids]),
            })
        results["eval"] = evaluate_video_corpus(examples)
        if dist.rank() == 0:
            print(json.dumps(results["eval"], indent=2))

    if dist.rank() == 0:
        with open(os.path.join(args.output_dir, "mm_results.json"), "w") as f:
            json.dump(results, f, indent=2, default=float)
    dist.barrier()
    return results


if __name__ == "__main__":
    main()
