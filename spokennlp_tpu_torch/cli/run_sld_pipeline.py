"""SLD pipeline orchestrator CLI: manifests -> features -> k-means ->
tokens -> join -> BPE -> train, with per-(speed, shard) fan-out, on PyTorch.

Counterpart of ``spokennlp_tpu/cli/run_sld_pipeline.py`` (the reference's
staged shell script, sld/run.sh:51-280, stage fan-out :104-130) with the
same flags plus ``--device`` (default ``cuda``; raises without a card),
where stage 2 (WavLM features, projects/sld_pipeline.py) and stage 7
(cli/run_sld.py) run. ``--model_name`` is a local HF WavLM or HuBERT
directory. Run feature shards in parallel processes with --nshard N --rank
R, then the remaining stages once.

    python -m spokennlp_tpu_torch.cli.run_sld_pipeline --audio_dir wavs \
        --transcript_file trans.tsv --work_dir work --model_name wavlm-large
"""

from __future__ import annotations

import argparse
import json


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--audio_dir", required=True, help="dir of 16 kHz .wav files")
    p.add_argument("--transcript_file", required=True,
                   help="TSV: <relpath or utt id>\\t<text>")
    p.add_argument("--work_dir", required=True)
    p.add_argument("--start_stage", type=int, default=1)
    p.add_argument("--stop_stage", type=int, default=7)
    p.add_argument("--speeds", type=float, nargs="+", default=[0.9, 1.0, 1.1])
    p.add_argument("--nshard", type=int, default=1)
    p.add_argument("--rank", type=int, default=None,
                   help="dump only this feature shard (parallel fan-out)")
    p.add_argument("--layer", type=int, default=23)
    p.add_argument("--model_name", default="microsoft/wavlm-large")
    p.add_argument("--n_clusters", type=int, default=2000)
    p.add_argument("--kmeans_percent", type=float, default=0.104)
    p.add_argument("--bpe_vocab_size", type=int, default=6000)
    p.add_argument("--valid_percent", type=float, default=0.05)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--train_args", default="{}",
                   help='JSON dict forwarded to run_sld (e.g. '
                   '\'{"num_train_epochs": 3}\')')
    p.add_argument("--device", default="cuda",
                   help="torch device of stages 2 and 7; cuda raises when no card is present")
    args = p.parse_args(argv)

    from spokennlp_tpu_torch.projects.sld_pipeline import run_sld_stages

    return run_sld_stages(
        args.audio_dir,
        args.transcript_file,
        args.work_dir,
        start_stage=args.start_stage,
        stop_stage=args.stop_stage,
        speeds=tuple(args.speeds),
        nshard=args.nshard,
        rank=args.rank,
        layer=args.layer,
        model_name=args.model_name,
        n_clusters=args.n_clusters,
        kmeans_percent=args.kmeans_percent,
        bpe_vocab_size=args.bpe_vocab_size,
        valid_percent=args.valid_percent,
        seed=args.seed,
        train_kwargs=json.loads(args.train_args),
        device=args.device,
    )


if __name__ == "__main__":
    main()
