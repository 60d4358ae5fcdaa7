"""Windowed inference engine: batched forward over document windows.

Counterpart of ``predict_windows_scanned`` and ``run_topic_seg_inference`` in
``spokennlp_tpu/eval/inference.py`` for the "lt" predictor:

  host featurize -> pad to a fixed (batch, L) grid -> forward per batch on
  the model's device -> gather logits at sentence positions on the device ->
  one copy to the host -> per-document aggregation -> Pk/WD/F1.

Featurization, aggregation and the metrics are the port's copies of the
JAX package's host modules (``data.windowing_fast``, ``data.windowing``,
``eval.seg_metrics``).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from spokennlp_tpu_torch.data import windowing as W
from spokennlp_tpu_torch.data.windowing_fast import window_documents_stacked
from spokennlp_tpu_torch.eval import seg_metrics


def predict_windows_scanned(
    model: torch.nn.Module,
    batch: Dict[str, np.ndarray],
    batch_size: int,
    gather_sents: bool = False,
) -> np.ndarray:
    """Score every window on the model's device, ``batch_size`` at a time.

    Returns (N, L, C) token logits, or (N, K, C) logits gathered at the
    windows' ``sent_positions`` when ``gather_sents`` (the only slots the
    aggregation reads). The tail batch is padded by repeating the last
    window, so every batch has one shape. Logits cross to the host once, in
    bfloat16, as the JAX engine fetches them. The model runs in eval mode
    (no dropout, the inference kernels) and goes back to its mode after.
    """
    n, L = batch["input_ids"].shape
    B = batch_size
    nb = max((n + B - 1) // B, 1)
    device = next(model.parameters()).device

    def grid(a: np.ndarray) -> torch.Tensor:
        flat = np.empty((nb * B,) + a.shape[1:], a.dtype)
        flat[:n] = a
        flat[n:] = a[-1]
        return torch.from_numpy(flat.reshape((nb, B) + a.shape[1:]))

    keys = ["input_ids", "attention_mask", "token_type_ids"]
    if gather_sents:
        keys.append("sent_positions")
    grids = [grid(batch[k]) for k in keys]
    outs = []
    was_training = model.training
    model.eval()
    try:
        with torch.inference_mode():
            for i in range(nb):
                ids, mask, tt, *pos = (g[i].to(device) for g in grids)
                logits = model(ids, attention_mask=mask, token_type_ids=tt)["token_logits"]
                if gather_sents:
                    logits = torch.take_along_dim(logits, pos[0].long()[:, :, None], dim=1)
                outs.append(logits.to(torch.bfloat16))
            out = torch.cat(outs).cpu().float().numpy()
    finally:
        model.train(was_training)
    return out[:n]


def run_topic_seg_inference(
    model: torch.nn.Module,
    docs: Sequence[Dict],
    windowing_cfg,
    batch_size: int = 32,
    threshold: Optional[float] = None,
    topk: Optional[int] = None,
    f1_at_k: Optional[int] = None,
    ts_score_predictor: str = "lt",
) -> Dict:
    """Full predict pipeline for a corpus of tokenized documents.

    Args:
      docs: each {"sent_token_ids": [[int]], "labels": [int]}.

    Returns:
      {"metrics": {...}, "per_doc": [{"labels", "scores"}], "num_windows": N}.
    """
    if ts_score_predictor != "lt":
        raise NotImplementedError(f"ts_score_predictor={ts_score_predictor!r} is not ported yet")
    batch = window_documents_stacked(docs, windowing_cfg)
    if batch["input_ids"].shape[0] == 0:
        raise ValueError("no windows to stack")
    scores = predict_windows_scanned(model, batch, batch_size, gather_sents=True)
    per_doc = W.aggregate_gathered_predictions(
        batch["example_id"], batch["sent_labels"], scores, num_examples=len(docs)
    )
    kept = [(d["scores"], d["labels"].tolist()) for d in per_doc if len(d["labels"])]
    metrics = seg_metrics.compute_example_level_metric(
        [s for s, _ in kept],
        [l for _, l in kept],
        threshold=threshold,
        topk=topk,
        f1_at_k=f1_at_k,
    )
    return {"metrics": metrics, "per_doc": per_doc, "num_windows": int(batch["input_ids"].shape[0])}
