"""Packed windowed inference: several short windows in one max_seq_length row.

Counterpart of ``spokennlp_tpu/eval/packed_inference.py``. The featurizer
cuts windows at sentence boundaries, so a window of L tokens is mostly
padding on corpora of short documents. Here windows are bin-packed
first-fit-decreasing into full rows; ``pack_segment_ids`` (0 on padding,
i + 1 on the row's i-th window) keeps them apart in attention, and position
ids restart at every window, so each window's logits are those of the
unpacked computation. On the card the dense trunk's kernels take the packed
segment ids where they take the padding mask otherwise: kernel 3 at batches
of 32 or fewer, kernels 1 + 2 above (``attention_impl="auto"``).

``pack_windows``, ``PackedBatchItem`` and ``build_packed_batch`` are the
port's own copies of the JAX module's numpy code.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from spokennlp_tpu_torch.data.windowing import Window
from spokennlp_tpu_torch.eval.inference import evaluating, model_device, pad_rows

PACKED_KEYS = ("input_ids", "attention_mask", "pack_segment_ids", "position_ids")


@dataclasses.dataclass
class PackedBatchItem:
    """One packed sequence: which windows it holds and where."""

    window_indices: List[int]
    offsets: List[int]
    lengths: List[int]


def pack_windows(real_lengths: Sequence[int], max_seq_length: int) -> List[PackedBatchItem]:
    """First-fit-decreasing bin packing of window content lengths."""
    order = np.argsort(-np.asarray(real_lengths), kind="stable")
    bins: List[PackedBatchItem] = []
    bin_free: List[int] = []
    for wi in order:
        n = int(real_lengths[wi])
        placed = False
        for b, free in enumerate(bin_free):
            if free >= n:
                item = bins[b]
                item.offsets.append(max_seq_length - free)
                item.window_indices.append(int(wi))
                item.lengths.append(n)
                bin_free[b] -= n
                placed = True
                break
        if not placed:
            bins.append(PackedBatchItem(window_indices=[int(wi)], offsets=[0], lengths=[n]))
            bin_free.append(max_seq_length - n)
    return bins


def build_packed_batch(
    windows: Sequence[Window], max_seq_length: int
) -> Tuple[Dict[str, np.ndarray], List[PackedBatchItem]]:
    """Pack featurized windows into dense sequences.

    Returns arrays: input_ids, pack_segment_ids (0 pad, i+1 = slot),
    position_ids (restart per window), attention_mask, plus the packing
    plan for unpacking logits.
    """
    real_lengths = [int(w.attention_mask.sum()) for w in windows]
    plan = pack_windows(real_lengths, max_seq_length)
    P = len(plan)
    L = max_seq_length
    input_ids = np.zeros((P, L), np.int32)
    seg = np.zeros((P, L), np.int32)
    pos = np.zeros((P, L), np.int32)
    for p, item in enumerate(plan):
        for slot, (wi, off, n) in enumerate(zip(item.window_indices, item.offsets, item.lengths)):
            w = windows[wi]
            input_ids[p, off : off + n] = w.input_ids[:n]
            seg[p, off : off + n] = slot + 1
            pos[p, off : off + n] = np.arange(n)
    batch = {
        "input_ids": input_ids,
        "pack_segment_ids": seg,
        "position_ids": pos,
        "attention_mask": (seg > 0).astype(np.int32),
    }
    return batch, plan


def make_packed_predict_fn(model: torch.nn.Module):
    """(input_ids, attention_mask, pack_segment_ids, position_ids), numpy or
    tensors, -> (B, L, C) float32 token logits of the packed rows on the
    model's device, in eval mode."""
    device = model_device(model)

    def predict(input_ids, attention_mask, pack_segment_ids, position_ids) -> torch.Tensor:
        ids, mask, seg, pos = (torch.as_tensor(a).to(device) for a in
                               (input_ids, attention_mask, pack_segment_ids, position_ids))
        with evaluating(model):
            out = model(ids, attention_mask=mask, token_type_ids=torch.zeros_like(ids),
                        position_ids=pos, pack_segment_ids=seg)
        return out["token_logits"].float()

    return predict


def predict_windows_packed(
    model: torch.nn.Module,
    windows: Sequence[Window],
    max_seq_length: int,
    batch_size: int = 32,
) -> np.ndarray:
    """Score windows via packing; returns (N, L, C) float32 logits aligned
    to the original (unpacked) window layout, zero past each window's real
    length. Packed rows run ``batch_size`` at a time, the tail padded with
    repeated rows."""
    batch, plan = build_packed_batch(windows, max_seq_length)
    predict = make_packed_predict_fn(model)
    P = batch["input_ids"].shape[0]
    logits_packed = []
    for s in range(0, P, batch_size):
        e = min(s + batch_size, P)
        args = [pad_rows(batch[k][s:e], batch_size) for k in PACKED_KEYS]
        logits_packed.append(predict(*args)[: e - s].cpu().numpy())
    logits_packed = np.concatenate(logits_packed, 0)

    C = logits_packed.shape[-1]
    out = np.zeros((len(windows), max_seq_length, C), np.float32)
    for p, item in enumerate(plan):
        for wi, off, n in zip(item.window_indices, item.offsets, item.lengths):
            out[wi, :n] = logits_packed[p, off : off + n]
    return out
