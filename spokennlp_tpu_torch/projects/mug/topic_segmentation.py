"""MUG Track 1: PoNet topic segmentation over EOS-marked meeting windows.

Counterpart of ``spokennlp_tpu/projects/mug/topic_segmentation.py``: the
windowing (``EosWindow``, ``window_document_eos``, ``stack_eos_windows``) is
the port's own copy of the JAX module's (same behaviour; numpy and the
standard library), the train step and the prediction loop are PyTorch.

Reimplements the reference pipeline (reference: alimeeting4mug/src/
topic_segment/ponet_topic_segmentation.py): every sentence is suffixed with
an [EOS] marker carrying its label; documents are chunked with the same
shared-sentence sliding-window rule as emnlp2023 (window loop :617-680); each
token carries a per-sentence ``segment_ids`` value for PoNet's segment
max-pooling (:564-596; CLS -> 0, pads -> n_sentences + 1).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from spokennlp_tpu_torch.configs import WindowingConfig

IGNORE = -100


@dataclasses.dataclass
class EosWindow:
    example_id: int
    input_ids: np.ndarray  # (L,)
    attention_mask: np.ndarray
    token_type_ids: np.ndarray
    segment_ids: np.ndarray  # (L,) per-token sentence id
    labels: np.ndarray  # (L,) label at EOS positions else IGNORE
    sent_ids: List[int]  # document sentence indices labeled in this window


def window_document_eos(
    sent_token_ids: Sequence[Sequence[int]],
    sent_labels: Sequence[int],
    cfg: WindowingConfig,
    eos_token_id: int,
    example_id: int = 0,
    paragraph_ids: Optional[Sequence[int]] = None,
) -> List[EosWindow]:
    """Chunk an EOS-marked document into overlapping fixed windows.

    ``paragraph_ids``: optional per-sentence paragraph index — when given,
    segment_ids use paragraph granularity (use_paragraph_segment mode,
    reference :588-591); otherwise sentence granularity.
    """
    n_sent = len(sent_token_ids)
    if n_sent == 0:
        return []
    L = cfg.max_seq_length

    flat: List[int] = []
    tok_sent: List[int] = []  # sentence index (0-based) per token
    eos_pos: List[int] = []
    for si, sent in enumerate(sent_token_ids):
        flat.extend(int(t) for t in sent)
        tok_sent.extend([si] * len(sent))
        eos_pos.append(len(flat))
        flat.append(eos_token_id)
        tok_sent.append(si)
    total = len(flat)

    seg_value = (
        (lambda si: int(paragraph_ids[si]))
        if paragraph_ids is not None
        else (lambda si: si + 1)
    )

    windows: List[EosWindow] = []
    token_left = 0
    sent_left = 0
    sent_i = 0
    while sent_i < n_sent:
        token_right = eos_pos[sent_i] + 1
        if (token_right - token_left) >= L - 1 or token_right == total:
            single = sent_i == sent_left
            ids = [cfg.cls_token_id] + flat[token_left:token_right]
            ids = ids[:L]
            n = len(ids)
            segs = [0] + [seg_value(tok_sent[p]) for p in range(token_left, token_right)]
            segs = segs[:L]
            labels = np.full(L, IGNORE, np.int32)
            sent_ids: List[int] = []
            for si in range(sent_left, sent_i + 1):
                pos = eos_pos[si] - token_left + 1
                if pos >= L:
                    break
                if si != sent_i:  # last sentence of the window is masked
                    labels[pos] = sent_labels[si]
                    if sent_labels[si] != IGNORE:
                        sent_ids.append(si)
            if single and n == L:
                ids[-1] = eos_token_id  # truncated single sentence keeps an EOS
            input_ids = np.full(L, cfg.pad_token_id, np.int32)
            input_ids[:n] = np.asarray(ids, np.int32)
            attention_mask = np.zeros(L, np.int32)
            attention_mask[:n] = 1
            segment_ids = np.full(L, n_sent + 1, np.int32)
            segment_ids[:n] = np.asarray(segs[:n], np.int32)
            windows.append(
                EosWindow(
                    example_id=example_id,
                    input_ids=input_ids,
                    attention_mask=attention_mask,
                    token_type_ids=np.zeros(L, np.int32),
                    segment_ids=segment_ids,
                    labels=labels,
                    sent_ids=sent_ids,
                )
            )
            if single:
                token_left = token_right
                sent_left = sent_i + 1
                sent_i += 1
            elif token_right == total:
                sent_left = sent_i + 1
                sent_i += 1
                token_left = token_right
            else:
                token_left = eos_pos[sent_i - 1] + 1
                sent_left = sent_i
        else:
            sent_i += 1
    return windows


def stack_eos_windows(windows: Sequence[EosWindow]) -> Dict[str, np.ndarray]:
    out = {
        f: np.stack([getattr(w, f) for w in windows])
        for f in ("input_ids", "attention_mask", "token_type_ids", "segment_ids", "labels")
    }
    out["example_id"] = np.asarray([w.example_id for w in windows], np.int32)
    return out


def make_ponet_train_step(model, optimizer, generator=None):
    """The train step for PoNet token classification: masked cross-entropy
    on the labeled EOS positions (reference: modeling_ponet.py:85-97), one
    optimizer step. ``step(batch)`` takes a dict of (B, L) tensors on the
    model's device and returns {"loss": the batch's loss}; dropout masks come
    from ``generator``."""
    from spokennlp_tpu_torch.ops.losses import cross_entropy_with_ignore

    def step(batch):
        model.train()
        out = model(batch["input_ids"], attention_mask=batch["attention_mask"],
                    segment_ids=batch["segment_ids"], generator=generator)
        loss = cross_entropy_with_ignore(out["token_logits"], batch["labels"])
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        return {"loss": loss.detach()}

    return step


def predict_window_logits(model, batch: Dict[str, np.ndarray], batch_size: int) -> np.ndarray:
    """float32 token logits (N, L, C) of stacked windows, in eval mode, in
    batches of ``batch_size``; the last batch is filled up by repeating its
    last window, as the JAX loop does, so every call sees the same shape."""
    import torch

    model.eval()
    device = next(model.parameters()).device
    N = batch["input_ids"].shape[0]
    logits_all = []
    with torch.no_grad():
        for s in range(0, N, batch_size):
            e = min(s + batch_size, N)
            pad = batch_size - (e - s)
            arrays = []
            for k in ("input_ids", "attention_mask", "segment_ids"):
                a = batch[k][s:e]
                if pad:
                    a = np.concatenate([a, np.repeat(a[-1:], pad, 0)])
                arrays.append(torch.from_numpy(a).to(device))
            ids, am, sg = arrays
            out = model(ids, attention_mask=am, segment_ids=sg)
            logits_all.append(out["token_logits"].float().cpu().numpy()[: e - s])
    return np.concatenate(logits_all, 0)


def predict_boundaries(
    model,
    meetings: Sequence[Dict],
    tokenize_fn,
    cfg: WindowingConfig,
    eos_token_id: int,
    batch_size: int = 8,
    threshold: Optional[float] = None,
) -> List[List[int]]:
    """Predict 1-based boundary sentence ids per meeting (for submissions)."""
    all_windows: List[EosWindow] = []
    for eid, m in enumerate(meetings):
        sent_tokens = [tokenize_fn(s) for s in m["sentences"]]
        all_windows.extend(
            window_document_eos(
                sent_tokens, m["labels"], cfg, eos_token_id, example_id=eid
            )
        )
    logits_all = predict_window_logits(model, stack_eos_windows(all_windows), batch_size)

    boundaries: List[List[int]] = [[] for _ in meetings]
    for w, lg in zip(all_windows, logits_all):
        live = w.labels != IGNORE
        win_logits = lg[live]
        if threshold is not None:
            p = np.exp(win_logits - win_logits.max(-1, keepdims=True))
            p = p / p.sum(-1, keepdims=True)
            preds = (p[:, 0] >= threshold).astype(np.int32)
        else:
            preds = (np.argmax(win_logits, -1) == 0).astype(np.int32)
        for sid, pred in zip(w.sent_ids, preds):
            if pred:
                boundaries[w.example_id].append(sid + 1)  # 1-based
    return [sorted(set(b)) for b in boundaries]
