"""Result statistics of the port: the multi-seed table.

The port's copy of ``compute_avg_std`` in ``spokennlp_tpu/eval/analysis.py``
(the reference's statistics_of_result.py:5-27).
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def compute_avg_std(runs: Sequence[Sequence[float]], metrics: Sequence[str]) -> Dict[str, Dict]:
    """{metric: {"mean", "std"}} over runs (one row of metric values per
    run); the sample standard deviation, 0 for a single run."""
    out = {}
    arr = np.asarray(runs, dtype=np.float64)  # (n_runs, n_metrics)
    for i, m in enumerate(metrics):
        vals = arr[:, i]
        out[m] = {
            "mean": float(vals.mean()),
            "std": float(vals.std(ddof=1)) if len(vals) > 1 else 0.0,
        }
    return out
