"""Windowed inference engine: batched forward over document windows.

Counterpart of ``spokennlp_tpu/eval/inference.py``:

  host featurize -> pad to a fixed (batch, L) grid -> forward per batch on
  the model's device -> gather logits at sentence positions on the device ->
  one copy to the host -> per-document aggregation -> Pk/WD/F1.

``ts_score_predictor="cos"`` scores each labelled sentence by the sigmoid of
its cosine similarity with the next one (``make_cos_predict_fn``);
``make_predict_fn`` / ``predict_windows`` are the per-batch scorer of full
(N, L, C) logits. Featurization, aggregation and the metrics are the port's
copies of the JAX package's host modules (``data.windowing_fast``,
``data.windowing``, ``eval.seg_metrics``).

Inside a ``torch.distributed`` process group of several ranks (data
parallel, as JAX shards the engine's batches over its mesh) the engine
splits the windows into one equal block a rank (``parallel.mesh.
rank_rows``, the last window repeated to fill), each rank scores its block
and the scores are gathered in rank order on every rank, so every rank
aggregates and scores the whole corpus; ``make_predict_fn``'s scorer takes
a batch whose rows divide by the world size and does the same within it.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from spokennlp_tpu_torch.data import windowing as W
from spokennlp_tpu_torch.data.windowing_fast import window_documents_stacked
from spokennlp_tpu_torch.eval import seg_metrics
from spokennlp_tpu_torch.objectives import cssl as cssl_ops
from spokennlp_tpu_torch.parallel import dist as dist_lib
from spokennlp_tpu_torch.parallel import mesh as mesh_lib


def model_device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


@contextlib.contextmanager
def evaluating(model: torch.nn.Module):
    """Eval mode (no dropout, the inference kernels) and no autograd for the
    block; the model goes back to its mode after."""
    was_training = model.training
    model.eval()
    try:
        with torch.inference_mode():
            yield
    finally:
        model.train(was_training)


def pad_rows(a: np.ndarray, rows: int) -> np.ndarray:
    """``a`` padded to ``rows`` rows by repeating its last row."""
    if len(a) == rows:
        return a
    return np.concatenate([a, np.repeat(a[-1:], rows - len(a), 0)])


def make_predict_fn(model: torch.nn.Module):
    """The window scorer: (input_ids, attention_mask, token_type_ids), numpy
    or tensors, -> (B, L, C) float32 token logits on the model's device, in
    eval mode; in a process group of several ranks each scores its block of
    the B rows (B must divide by the world size) and every rank gets all."""
    device = model_device(model)

    def predict(input_ids, attention_mask, token_type_ids) -> torch.Tensor:
        ids, mask, tt = (torch.as_tensor(a).to(device) for a in
                         (input_ids, attention_mask, token_type_ids))
        world = dist_lib.world_size()
        if world > 1:  # this rank's rows, then every rank's
            ids, mask, tt = (mesh_lib.shard_batch({"x": t}, dist_lib.rank(), world)["x"]
                             for t in (ids, mask, tt))
        with evaluating(model):
            out = model(ids, attention_mask=mask, token_type_ids=tt)
        logits = out["token_logits"].float()
        if world > 1:
            logits = torch.cat(dist_lib.all_gather_tensors(logits), 0)
        return logits

    return predict


def predict_windows(predict_fn, batch: Dict[str, np.ndarray], batch_size: int) -> np.ndarray:
    """Score every window with ``predict_fn`` (``make_predict_fn``) at one
    batch shape; the tail is padded with repeated windows. Returns (N, L, C)
    float32 logits for the N real windows."""
    n = batch["input_ids"].shape[0]
    outs: List[np.ndarray] = []
    for start in range(0, n, batch_size):
        end = min(start + batch_size, n)
        args = [pad_rows(batch[k][start:end], batch_size)
                for k in ("input_ids", "attention_mask", "token_type_ids")]
        outs.append(predict_fn(*args)[: end - start].cpu().numpy())
    return np.concatenate(outs, axis=0)


def make_cos_predict_fn(model: torch.nn.Module, temp: float):
    """The window scorer of ``ts_score_predictor="cos"``: (input_ids,
    attention_mask, token_type_ids, sent_positions, eop_mask, labels) ->
    (B, K) float32 sigmoid of the cosine similarity between each labelled
    sentence's features and the next one's, on the model's device."""
    device = model_device(model)

    def predict(input_ids, attention_mask, token_type_ids, sent_positions, eop_mask, labels):
        ids, mask, tt, pos, eop, lab = (torch.as_tensor(a).to(device) for a in (
            input_ids, attention_mask, token_type_ids, sent_positions, eop_mask, labels))
        with evaluating(model):
            out = model(ids, attention_mask=mask, token_type_ids=tt)
            feats = cssl_ops.gather_sentence_features(out["seq_output"], pos)
            eop_labels = torch.take_along_dim(lab, pos.long(), dim=1)
            sims, _ = cssl_ops.eop_pair_cosine_similarity(feats, eop_labels, eop, temp)
        return torch.sigmoid(sims.float())

    return predict


COS_KEYS = ("input_ids", "attention_mask", "token_type_ids", "sent_positions", "eop_mask",
            "labels")


def predict_cos_scores(model: torch.nn.Module, batch: Dict[str, np.ndarray], batch_size: int,
                       temp: float) -> np.ndarray:
    """(N, K) sigmoid-cos scores of every window, ``batch_size`` at a time
    (the tail padded with repeated windows)."""
    predict = make_cos_predict_fn(model, temp)
    n = batch["input_ids"].shape[0]
    sims = np.zeros(batch["sent_positions"].shape, np.float32)
    for s in range(0, n, batch_size):
        e = min(s + batch_size, n)
        parts = [pad_rows(batch[k][s:e], batch_size) for k in COS_KEYS]
        sims[s:e] = predict(*parts)[: e - s].cpu().numpy()
    return sims


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
    device = model_device(model)

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
    with evaluating(model):
        for i in range(nb):
            ids, mask, tt, *pos = (g[i].to(device) for g in grids)
            logits = model(ids, attention_mask=mask, token_type_ids=tt)["token_logits"]
            if gather_sents:
                logits = torch.take_along_dim(logits, pos[0].long()[:, :, None], dim=1)
            outs.append(logits.to(torch.bfloat16))
        out = torch.cat(outs).cpu().float().numpy()
    return out[:n]


def cos_per_doc(batch: Dict[str, np.ndarray], sims: np.ndarray, num_docs: int) -> List[Dict]:
    """Per document, in window order, the sigmoid-cos score and the label of
    every slot of ``eop_mask``: {"labels" (n,), "scores" (n,)}."""
    doc_scores: List[List[float]] = [[] for _ in range(num_docs)]
    doc_labels: List[List[int]] = [[] for _ in range(num_docs)]
    for wi in range(sims.shape[0]):
        live = batch["eop_mask"][wi].astype(bool)
        eid = int(batch["example_id"][wi])
        doc_scores[eid].extend(sims[wi][live].tolist())
        doc_labels[eid].extend(batch["sent_labels"][wi][live].tolist())
    return [{"labels": np.asarray(l, np.int32), "scores": np.asarray(s, np.float32)}
            for l, s in zip(doc_labels, doc_scores)]


def rank_block(batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """This rank's block of the stacked windows (``mesh.rank_rows``: equal
    blocks, the last window repeated past the end); the whole batch on one
    process."""
    world = dist_lib.world_size()
    if world == 1:
        return batch
    n = batch["input_ids"].shape[0]
    start, end = mesh_lib.rank_rows(n, dist_lib.rank(), world)
    rows = np.minimum(np.arange(start, end), n - 1)
    return {k: batch[k][rows] for k in COS_KEYS}


def run_topic_seg_inference(
    model: torch.nn.Module,
    docs: Sequence[Dict],
    windowing_cfg,
    batch_size: int = 32,
    threshold: Optional[float] = None,
    topk: Optional[int] = None,
    f1_at_k: Optional[int] = None,
    ts_score_predictor: str = "lt",
    cos_temp: float = 1.0,
) -> Dict:
    """Full predict pipeline for a corpus of tokenized documents.

    Args:
      docs: each {"sent_token_ids": [[int]], "labels": [int]}.
      ts_score_predictor: "lt" (token logits) or "cos" (sigmoid of the
        cosine similarity of adjacent labelled sentences at ``cos_temp``;
        per-document scores are 1-d).

    Returns:
      {"metrics": {...}, "per_doc": [{"labels", "scores"}], "num_windows": N}.
    """
    if ts_score_predictor not in ("lt", "cos"):
        raise ValueError(f"ts_score_predictor={ts_score_predictor!r}")
    batch = window_documents_stacked(docs, windowing_cfg)
    n = batch["input_ids"].shape[0]
    if n == 0:
        raise ValueError("no windows to stack")
    local, device = rank_block(batch), model_device(model)
    if ts_score_predictor == "cos":
        sims = dist_lib.gather_rows(predict_cos_scores(model, local, batch_size, cos_temp), n,
                                    device)
        per_doc = cos_per_doc(batch, sims, len(docs))
    else:
        scores = dist_lib.gather_rows(
            predict_windows_scanned(model, local, batch_size, gather_sents=True), n, device)
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
        ts_score_predictor=ts_score_predictor,
    )
    return {"metrics": metrics, "per_doc": per_doc, "num_windows": int(batch["input_ids"].shape[0])}
