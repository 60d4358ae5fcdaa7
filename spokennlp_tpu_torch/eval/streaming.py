"""Streamed inference: featurize on the host while the card computes.

Counterpart of ``spokennlp_tpu/eval/streaming.py``: the whole pipeline,
(tokenize ->) window -> upload -> forward -> gather -> download ->
aggregate -> metrics, in one pass in which the host featurizes chunk k + 1
while the device computes chunk k:

  featurize c0 | dispatch c0 | featurize c1 | dispatch c1 | ... | fetch
               |  device: c0 |  device: c1 (c0's download in flight) |

On the card, a chunk's arrays are staged in pinned host buffers and uploaded
with ``non_blocking=True`` on an upload stream; the forward runs on the
current stream after an event from the upload; its logits, gathered at
``sent_k`` sentence slots and rounded to bfloat16 as the batch engine
fetches them, come back into a pinned buffer on a download stream after an
event from the forward, and a last event marks them readable. Nothing in the
loop synchronizes: the fetch loop waits on each chunk's last event. On the
CPU the same steps run in order.

Two faults of the JAX module are not copied: its ``sent_k`` guard raised
when a window held exactly ``sent_k`` sentences (nothing cut; here it raises
only when a window holds more), and its fetch timing left out the time spent
starting the copies (here the download is queued inside ``dispatch`` and
``fetch`` times every wait).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from spokennlp_tpu_torch.data.windowing_fast import window_documents_stacked
from spokennlp_tpu_torch.eval.inference import evaluating, model_device

IGNORE = -100


class _Aggregator:
    """Incremental per-document gathering of window predictions.

    Same contract as windowing.aggregate_gathered_predictions, fed chunk by
    chunk in window order."""

    def __init__(self, num_docs: int):
        self.labels: List[List[int]] = [[] for _ in range(num_docs)]
        self.scores: List[List[np.ndarray]] = [[] for _ in range(num_docs)]

    def add_chunk(self, example_id, sent_labels, gathered_scores):
        for wi in range(sent_labels.shape[0]):
            live = sent_labels[wi] != IGNORE
            if not live.any():
                continue
            eid = int(example_id[wi])
            self.labels[eid].extend(sent_labels[wi][live].tolist())
            self.scores[eid].append(gathered_scores[wi][live])

    def per_doc(self, n_classes: int):
        out = []
        for lab, sc in zip(self.labels, self.scores):
            scores = np.concatenate(sc, 0) if sc else np.zeros((0, n_classes), np.float32)
            out.append({"labels": np.asarray(lab, np.int32), "scores": scores})
        return out


class _ChunkRunner:
    """Runs (C * B)-window chunks on the model's device: ids, lengths and
    sentence positions in, (C * B, K, classes) bfloat16 gathered logits
    out, as a host tensor and the event after which it may be read (None on
    the CPU)."""

    def __init__(self, model: torch.nn.Module, batch_size: int, seq_len: int):
        self.model, self.B, self.L = model, batch_size, seq_len
        self.device = model_device(model)
        self.cuda = self.device.type == "cuda"
        if self.cuda:
            self.upload = torch.cuda.Stream(self.device)
            self.download = torch.cuda.Stream(self.device)

    def _stage(self, arrays):
        """Host arrays -> device tensors, after an event on the upload stream."""
        if not self.cuda:
            return [torch.from_numpy(a) for a in arrays]
        pinned = [torch.from_numpy(a).pin_memory() for a in arrays]
        with torch.cuda.stream(self.upload):
            dev = [p.to(self.device, non_blocking=True) for p in pinned]
        compute = torch.cuda.current_stream(self.device)
        compute.wait_stream(self.upload)
        for t in dev:  # allocated on the upload stream, read on the compute one
            t.record_stream(compute)
        return dev

    def __call__(self, ids: np.ndarray, lengths: np.ndarray, positions: np.ndarray):
        d_ids, d_len, d_pos = self._stage([ids, lengths, positions])
        B, L = self.B, self.L
        outs = []
        with evaluating(self.model):
            cols = torch.arange(L, device=self.device)[None, :]
            for s in range(0, d_ids.shape[0], B):
                x = d_ids[s:s + B].int()
                mask = (cols < d_len[s:s + B, None]).int()
                logits = self.model(x, attention_mask=mask,
                                    token_type_ids=torch.zeros_like(x))["token_logits"]
                logits = torch.take_along_dim(logits, d_pos[s:s + B].long()[:, :, None], dim=1)
                outs.append(logits.to(torch.bfloat16))
            res = torch.cat(outs)
        if not self.cuda:
            return res, None
        host = torch.empty(res.shape, dtype=res.dtype, pin_memory=True)
        compute = torch.cuda.current_stream(self.device)
        self.download.wait_stream(compute)
        with torch.cuda.stream(self.download):
            host.copy_(res, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(self.download)
        res.record_stream(self.download)
        return host, ready


def stream_topic_seg_inference(
    model: torch.nn.Module,
    docs: Sequence[Dict],
    windowing_cfg,
    batch_size: int = 128,
    chunk_batches: int = 2,
    sent_k: int = 64,
    threshold: Optional[float] = 0.5,
    topk: Optional[int] = None,
    f1_at_k: Optional[int] = None,
    tokenize_fn: Optional[Callable] = None,
    docs_per_group: int = 64,
    compute_metrics: bool = True,
) -> Dict:
    """Single-pass streamed inference over a document corpus.

    Args:
      docs: tokenized docs {"sent_token_ids", "labels"}, or, with
        ``tokenize_fn`` (a list of sentences -> a list of id lists), raw docs
        {"sentences": [str], "labels"} tokenized group by group inside the
        stream.
      sent_k: the sentence slots gathered on the device; a window holding
        more sentences raises (windows can hold up to max_seq_length//2+1).
      docs_per_group: featurization granularity; each group's windows are
        appended to a buffer that drains in fixed (chunk_batches, B) chunks.

    Returns {"metrics", "per_doc", "timing"}; timing splits the wall time
    into featurize / dispatch (upload, forward and download queued) / fetch
    (waiting for the downloads) / aggregate / metrics seconds, with the
    total, the window count and windows per second.
    """
    B = batch_size
    L = windowing_cfg.max_seq_length
    C = chunk_batches
    chunk_windows = C * B
    vocab_size = getattr(getattr(model, "enc_cfg", None), "vocab_size", 1 << 30)
    ids_dtype = np.int16 if vocab_size < 2 ** 15 else np.int32
    run = _ChunkRunner(model, B, L)

    t = {"featurize": 0.0, "dispatch": 0.0, "fetch": 0.0, "aggregate": 0.0, "metrics": 0.0}
    t0_total = time.perf_counter()

    # window buffer (SoA) drained in fixed-shape chunks
    buf: Dict[str, List[np.ndarray]] = {k: [] for k in ("ids", "len", "pos", "slab", "eid")}
    buffered = 0
    pending: List[tuple] = []
    n_windows = 0

    def _drain(final: bool = False):
        nonlocal buf, buffered
        while buffered >= chunk_windows or (final and buffered > 0):
            tick = time.perf_counter()
            cat = {k: np.concatenate(v, 0) if len(v) > 1 else v[0] for k, v in buf.items()}
            take = min(chunk_windows, buffered)
            chunk = {k: v[:take] for k, v in cat.items()}
            if take < chunk_windows:  # tail: pad by repeating the last row
                pad = chunk_windows - take
                chunk = {k: np.concatenate([v, np.repeat(v[-1:], pad, 0)])
                         for k, v in chunk.items()}
            buf = {k: [v[take:]] for k, v in cat.items()}
            buffered -= take
            t["featurize"] += time.perf_counter() - tick
            tick = time.perf_counter()
            host, ready = run(chunk["ids"], chunk["len"], chunk["pos"])
            pending.append((host, ready, chunk["eid"], chunk["slab"], take))
            t["dispatch"] += time.perf_counter() - tick

    for g0 in range(0, len(docs), docs_per_group):
        group = docs[g0 : g0 + docs_per_group]
        tick = time.perf_counter()
        if tokenize_fn is not None:
            enc = tokenize_fn([s for d in group for s in d["sentences"]])
            group2, i = [], 0
            for d in group:
                k = len(d["sentences"])
                group2.append({"sent_token_ids": enc[i : i + k], "labels": d["labels"]})
                i += k
            group = group2
        # one slot beyond sent_k shows whether a window holds more sentences
        stacked = window_documents_stacked(group, windowing_cfg,
                                           max_sentences_per_window=sent_k + 1)
        nw = stacked["input_ids"].shape[0]
        if nw:
            if stacked["sent_mask"][:, sent_k].any():
                raise ValueError(
                    f"a window holds more than sent_k={sent_k} sentences; raise sent_k "
                    "(windows can hold up to max_seq_length//2+1)")
            buf["ids"].append(stacked["input_ids"].astype(ids_dtype))
            buf["len"].append(stacked["attention_mask"].sum(1, dtype=np.int32))
            buf["pos"].append(stacked["sent_positions"][:, :sent_k].astype(np.int16))
            buf["slab"].append(stacked["sent_labels"][:, :sent_k])
            buf["eid"].append(stacked["example_id"] + g0)
            buffered += nw
            n_windows += nw
        t["featurize"] += time.perf_counter() - tick
        _drain()
    _drain(final=True)

    agg = _Aggregator(len(docs))
    for host, ready, eid, slab, keep in pending:
        tick = time.perf_counter()
        if ready is not None:
            ready.synchronize()
        logits = host.float().numpy().reshape(chunk_windows, sent_k, -1)[:keep]
        t["fetch"] += time.perf_counter() - tick
        tick = time.perf_counter()
        agg.add_chunk(eid[:keep], slab[:keep], logits)
        t["aggregate"] += time.perf_counter() - tick
    tick = time.perf_counter()
    per_doc = agg.per_doc(n_classes=2)
    t["aggregate"] += time.perf_counter() - tick

    metrics = {}
    if compute_metrics:
        from spokennlp_tpu_torch.eval import seg_metrics

        tick = time.perf_counter()
        kept = [(d["scores"], d["labels"].tolist()) for d in per_doc if len(d["labels"])]
        metrics = seg_metrics.compute_example_level_metric(
            [s for s, _ in kept], [l for _, l in kept],
            threshold=threshold, topk=topk, f1_at_k=f1_at_k)
        t["metrics"] = time.perf_counter() - tick

    total = time.perf_counter() - t0_total
    timing = {**{k: round(v, 4) for k, v in t.items()},
              "total": round(total, 4), "windows": n_windows,
              "windows_per_sec": round(n_windows / total, 1) if total else 0.0}
    return {"metrics": metrics, "per_doc": per_doc, "timing": timing}
