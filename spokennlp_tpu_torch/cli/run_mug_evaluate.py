"""MUG challenge offline scorer CLI (reference: challenge_evaluate.py __main__).

The port's own copy of ``spokennlp_tpu/cli/run_mug_evaluate.py`` (same
flags and output; host code only).

Usage:
  python -m spokennlp_tpu_torch.cli.run_mug_evaluate --task topic_segmentation \
      --label_file dev_labels.jsonl --pred_file submit.jsonl
"""

from __future__ import annotations

import argparse
import json


def main(argv=None):
    from spokennlp_tpu_torch.projects.mug.evaluate import TRACK_EVALUATORS, evaluate_files

    p = argparse.ArgumentParser()
    p.add_argument("--task", required=True, choices=sorted(TRACK_EVALUATORS))
    p.add_argument("--label_file", required=True)
    p.add_argument("--pred_file", required=True)
    args = p.parse_args(argv)
    res = evaluate_files(args.task, args.label_file, args.pred_file)
    print(json.dumps(res, indent=2, default=float, ensure_ascii=False))
    return res


if __name__ == "__main__":
    main()
