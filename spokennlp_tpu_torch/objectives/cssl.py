"""Sentence-level features for the topic-segmentation heads.

Counterpart of the inference part of ``spokennlp_tpu/objectives/cssl.py``;
the contrastive objective belongs to the training port.
"""

from __future__ import annotations

import torch


def gather_sentence_features(seq_output: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Hidden states at sentence (BOS) positions.

    seq_output: (B, L, H); positions: (B, K) int -> (B, K, H).
    """
    return torch.take_along_dim(seq_output, positions.long()[..., None], dim=1)
