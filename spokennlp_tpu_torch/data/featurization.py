"""Top-level featurization: documents -> paired (anchor, DA) training batches.

The port's own copy of ``spokennlp_tpu/data/featurization.py`` (same behaviour; imports
only the port, numpy and the standard library).

Ties together windowing (data/windowing.py), augmentation (data/
augmentation.py) and CSSL sampling (data/cssl_sampling.py) into the batch
layout the jitted train step consumes: every tensor is (B, 2, ...) with view
0 = anchor, view 1 = DA (reference batch layout:
emnlp2023-topic_segmentation/src/ts_sentence_seq_labeling.py:881-916).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from spokennlp_tpu_torch.configs import TopicSegConfig, WindowingConfig
from spokennlp_tpu_torch.data import augmentation as aug
from spokennlp_tpu_torch.data import windowing as W
from spokennlp_tpu_torch.data.cssl_sampling import build_cssl_list_indices


def _window_pair_one(args) -> List[Tuple[W.Window, W.Window]]:
    """Per-document windowing+pairing (module-level so worker processes can
    pickle it)."""
    eid, doc, da_doc, cfg, mspw = args
    anchor_windows = W.window_document(
        doc["sent_token_ids"],
        doc["labels"],
        cfg,
        example_id=eid,
        max_sentences_per_window=mspw,
    )
    if not anchor_windows:
        return []
    da_windows = aug.pair_windows(anchor_windows, da_doc, cfg, eid)
    return list(zip(anchor_windows, da_windows))


def featurize_paired(
    docs: Sequence[Dict],
    cfg: WindowingConfig,
    rng: np.random.Generator,
    tssp_ablation: str = "none",
    max_sentences_per_window: Optional[int] = None,
    num_proc: int = 1,
) -> List[Tuple[W.Window, W.Window]]:
    """Window every document and pair each anchor window with its DA window.

    ``num_proc`` > 1 fans the per-document windowing out over worker
    processes (the reference preprocesses with datasets.map(num_proc=...),
    ts_sentence_seq_labeling.py:945-954). Augmentation stays in-process:
    cross-document topic replacement needs the whole corpus and is cheap
    (index shuffling); the window loop is the hot host path.
    """
    da_docs = aug.augment_documents(docs, rng, tssp_ablation)
    jobs = [
        (eid, doc, da_doc, cfg, max_sentences_per_window)
        for eid, (doc, da_doc) in enumerate(zip(docs, da_docs))
    ]
    if num_proc > 1 and len(jobs) > 1:
        import multiprocessing as mp
        from concurrent.futures import ProcessPoolExecutor

        with ProcessPoolExecutor(
            max_workers=num_proc, mp_context=mp.get_context("fork")
        ) as ex:
            chunks = list(
                ex.map(_window_pair_one, jobs,
                       chunksize=max(1, len(jobs) // (4 * num_proc)))
            )
    else:
        chunks = [_window_pair_one(j) for j in jobs]
    return [pair for chunk in chunks for pair in chunk]


def collate_paired(
    pairs: Sequence[Tuple[W.Window, W.Window]],
    task_cfg: TopicSegConfig,
    rng: np.random.Generator,
) -> Dict[str, np.ndarray]:
    """Stack window pairs into a (B, 2, ...) batch + host-side CSSL indices."""
    fields = (
        "input_ids",
        "attention_mask",
        "token_type_ids",
        "labels",
        "sent_positions",
        "sent_mask",
        "eop_mask",
        "sent_labels",
        "pair_orders",
    )
    batch: Dict[str, np.ndarray] = {}
    for f in fields:
        batch[f] = np.stack(
            [np.stack([getattr(a, f), getattr(d, f)]) for a, d in pairs]
        )
    batch["example_id"] = np.asarray([a.example_id for a, _ in pairs], np.int32)

    if task_cfg.cl_loss_weight != 0 and task_cfg.cl_anchor_level in (
        "eop_list",
        "eot_list",
    ):
        B, _, K = batch["eop_mask"].shape
        anchor_eop_labels = np.where(
            batch["eop_mask"][:, 0] == 1, batch["sent_labels"][:, 0], 0
        )
        idx = build_cssl_list_indices(
            anchor_eop_labels,
            batch["eop_mask"][:, 0],
            task_cfg.cl_anchor_level,
            task_cfg.cl_positive_k,
            task_cfg.cl_negative_k,
            rng,
            max_anchors=B * K,
        )
        batch["cssl_anchor_indices"] = idx["anchor_indices"]
        batch["cssl_positive_indices"] = idx["positive_indices"]
        batch["cssl_negative_indices"] = idx["negative_indices"]
        batch["cssl_anchor_valid"] = idx["anchor_valid"]
    return batch


def batches_from_docs(
    docs: Sequence[Dict],
    wcfg: WindowingConfig,
    task_cfg: TopicSegConfig,
    batch_size: int,
    rng: np.random.Generator,
    shuffle: bool = True,
    drop_last: bool = True,
    max_sentences_per_window: Optional[int] = None,
    num_proc: int = 1,
):
    """Generator of training batches (one epoch). DA is re-sampled each call,
    like the reference's per-fingerprint datasets.map cache being rebuilt per
    run (metric parity, not bitwise parity)."""
    pairs = featurize_paired(
        docs,
        wcfg,
        rng,
        task_cfg.tssp_ablation,
        max_sentences_per_window=max_sentences_per_window,
        num_proc=num_proc,
    )
    order = np.arange(len(pairs))
    if shuffle:
        rng.shuffle(order)
    n = len(pairs)
    end = n - (n % batch_size) if drop_last else n
    for start in range(0, end, batch_size):
        chunk = [pairs[i] for i in order[start : start + batch_size]]
        while len(chunk) < batch_size:  # pad short tail by repetition
            chunk = chunk + chunk[: batch_size - len(chunk)]
        yield collate_paired(chunk, task_cfg, rng)
