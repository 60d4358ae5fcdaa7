"""Ditto evaluation CLI: learning-free sentence embeddings on STS + transfer,
on PyTorch.

Counterpart of ``spokennlp_tpu/cli/run_ditto.py`` (reference:
ditto/evaluation_ditto.py:37-215, run_eval_ditto.sh:17-37) with the same
flags plus ``--device`` (default ``cuda``; raises without a card): loads a
local encoder checkpoint (a native directory or an HF bert/electra
directory, read without ``transformers`` by ``cli/common.py``; a directory
that cannot be read raises), pools token states with any of the nine
poolers (Diagonal Attention Pooling picks (layer, head) from the recipe
table when not given), and evaluates STS (Spearman), the SentEval transfer
and probing tasks and the STS-B/SICK relatedness regression
(projects/ditto.py). The encoder runs in float32 with
``output_hidden_states``, so on the card every batch runs the fused
attention and MLP kernels (kernels 1 and 2) once a layer.

    python -m spokennlp_tpu_torch.cli.run_ditto --model_name_or_path ckpt \\
        --output_dir out --sts_tsv sts.tsv
"""

from __future__ import annotations

import argparse
import json
import os


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--model_name_or_path", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--pooler", default="att_first_last")
    p.add_argument("--layer", type=int, default=None)
    p.add_argument("--head", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--classifier", default="logreg", choices=["logreg", "mlp"],
                   help="transfer-task probe: logreg = fast sklearn; mlp = the "
                   "SentEval pytorch-classifier protocol (adam, tenacity-5 "
                   "early stop, l2 grid; published-comparable numbers)")
    p.add_argument("--mlp_nhid", type=int, default=0,
                   help="hidden units for --classifier mlp (0 = logistic "
                   "regression, the Ditto protocol)")
    p.add_argument("--max_seq_length", type=int, default=128)
    p.add_argument("--sts_tsv", nargs="*", default=[],
                   help="STS tsv files: sent1\\tsent2\\tscore")
    p.add_argument("--senteval_sts_dir", default=None,
                   help="SentEval STS12-16 style task dir")
    p.add_argument("--senteval_sts_subsets", nargs="*", default=[])
    p.add_argument("--transfer_dir", default=None,
                   help="SentEval downstream-task data root")
    p.add_argument("--transfer_tasks", nargs="*", default=[],
                   help="subset of MR CR SUBJ MPQA SST2 TREC MRPC")
    p.add_argument("--probing_files", nargs="*", default=[],
                   help="SentEval probing-task files (tr|va|te\\tlabel\\tsent)")
    p.add_argument("--relatedness_dir", default=None,
                   help="STS-B/SICK relatedness task dir")
    p.add_argument("--relatedness_format", default="tsv",
                   choices=["tsv", "sick", "stsb"])
    p.add_argument("--device", default="cuda",
                   help="torch device to run on; cuda raises when no card is present")
    return p


def load_encoder(args, device):
    """(the encoder on ``device`` in eval mode, tokenize_fn, special ids)
    from ``--model_name_or_path``; ``cls`` without pooler weights raises."""
    import dataclasses

    import torch

    from spokennlp_tpu_torch.cli import common
    from spokennlp_tpu_torch.configs import EncoderConfig
    from spokennlp_tpu_torch.models.convert import jax_params_to_state_dict
    from spokennlp_tpu_torch.models.encoder import Encoder

    ns = argparse.Namespace(model_name_or_path=args.model_name_or_path, vocab_file=None)
    tokenize_fn, special = common.resolve_tokenizer(ns)
    enc_cfg, params = common.maybe_load_pretrained(ns, EncoderConfig())
    if "encoder" in params:
        params = params["encoder"]
    if args.pooler == "cls" and "pooler" not in params:
        raise ValueError(
            "--pooler cls needs a checkpoint WITH pooler weights; this one "
            "has none (use cls_before_pooler or another pooler)"
        )
    enc_cfg = dataclasses.replace(enc_cfg, add_pooler="pooler" in params)
    with torch.device(device):
        encoder = Encoder(enc_cfg)
    encoder.load_state_dict(jax_params_to_state_dict(params), strict=True)
    return encoder.eval(), tokenize_fn, special


def main(argv=None):
    args = make_parser().parse_args(argv)
    os.makedirs(args.output_dir, exist_ok=True)

    import numpy as np

    from spokennlp_tpu_torch.cli.run_inference import resolve_device
    from spokennlp_tpu_torch.projects import ditto as D

    device = resolve_device(args.device)
    encoder, tokenize_fn, special = load_encoder(args, device)

    rec_layer, rec_head = D.recipe_for(args.model_name_or_path)
    layer = args.layer if args.layer is not None else rec_layer
    head = args.head if args.head is not None else rec_head
    if args.layer is None or args.head is None:
        print(f"(layer, head) = ({layer}, {head})"
              f"{' [recipe]' if (args.layer is None and args.head is None) else ''}")

    embed_fn = D.make_embed_fn(encoder, args.pooler, layer, head)

    L = args.max_seq_length
    cls_id, pad_id = special["cls"], special["pad"]

    def batch_tokenize(sentences):
        rows = [[cls_id] + tokenize_fn(s)[: L - 1] for s in sentences]
        ids = np.full((len(rows), L), pad_id, np.int32)
        mask = np.zeros((len(rows), L), np.int32)
        for i, r in enumerate(rows):
            ids[i, : len(r)] = r
            mask[i, : len(r)] = 1
        return ids, mask

    results = {}

    # ---------------- STS (Spearman), the reference's headline eval
    for path in args.sts_tsv:
        ds = D.load_sts_tsv(path)
        results[ds.name] = D.evaluate_sts(
            embed_fn, batch_tokenize, ds, batch_size=args.batch_size
        )
    if args.senteval_sts_dir:
        ds = D.load_senteval_sts(
            args.senteval_sts_dir, args.senteval_sts_subsets or None,
            os.path.basename(args.senteval_sts_dir.rstrip("/")),
        )
        results[ds.name] = D.evaluate_sts(
            embed_fn, batch_tokenize, ds, batch_size=args.batch_size
        )

    # ---------------- transfer probing (SentEval classifier protocol)
    if args.transfer_dir and args.transfer_tasks:
        tasks = {}
        for t in args.transfer_tasks:
            tdir = os.path.join(args.transfer_dir, t)
            if not os.path.isdir(tdir):
                tdir = args.transfer_dir
            tasks[t] = D.load_senteval_classification(tdir, t)
        results["transfer"] = D.evaluate_transfer_classification(
            embed_fn, batch_tokenize, tasks, batch_size=args.batch_size,
            classifier=args.classifier, mlp_nhid=args.mlp_nhid, device=device,
        )

    # ---------------- linguistic probing tasks (tr/va/te single files)
    if args.probing_files:
        tasks = {
            os.path.splitext(os.path.basename(f))[0]: D.load_senteval_probing(f)
            for f in args.probing_files
        }
        results["probing"] = D.evaluate_transfer_classification(
            embed_fn, batch_tokenize, tasks, batch_size=args.batch_size,
            classifier=args.classifier, mlp_nhid=args.mlp_nhid, device=device,
        )

    # ---------------- STS-B/SICK relatedness regression
    if args.relatedness_dir:
        data = D.load_relatedness_files(
            args.relatedness_dir, args.relatedness_format
        )
        results["relatedness"] = D.evaluate_similarity_regression(
            embed_fn, batch_tokenize, data, batch_size=args.batch_size, device=device,
        )

    with open(os.path.join(args.output_dir, "ditto_results.json"), "w") as f:
        json.dump(results, f, indent=2, default=float)
    print(json.dumps(results, indent=2, default=float))
    return results


if __name__ == "__main__":
    main()
