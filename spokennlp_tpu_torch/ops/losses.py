"""Masked classification losses.

Counterpart of ``spokennlp_tpu/ops/losses.py``. Ignored positions are
masked, never dropped, so every call keeps its shapes. Reductions follow the
reference's torch losses:

- plain and weighted cross-entropy: sum(w_i ce_i) / sum(w_i) over valid
  positions (``CrossEntropyLoss`` "mean" with ``ignore_index``);
- focal loss: the mean over ALL positions, ignored ones counting as 0, as
  the reference's ``FocalLoss`` takes ``torch.mean`` of that vector.

Under data parallel (``dp``, parallel/dist.py) each rank returns its
numerator over the global denominator, so the ranks' losses add up to the
loss of the whole batch.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

IGNORE = -100


def cross_entropy_with_ignore(
    logits: torch.Tensor,
    labels: torch.Tensor,
    class_weights: Optional[torch.Tensor] = None,
    focal_gamma: float = 0.0,
    ignore_id: int = IGNORE,
    dp=None,
) -> torch.Tensor:
    """Scalar cross-entropy over positions whose label != ``ignore_id``.

    logits (..., C), labels (...,) int; ``class_weights`` (C,) optional;
    ``focal_gamma`` > 0 applies the focal factor (1 - p_true)^gamma.
    ``dp``: this rank's share under data parallel.
    """
    num_classes = logits.shape[-1]
    logits = logits.reshape(-1, num_classes).float()
    labels = labels.reshape(-1)
    valid = labels != ignore_id
    safe = torch.where(valid, labels, 0).long()

    logp_true = F.log_softmax(logits, dim=-1).gather(1, safe[:, None])[:, 0]
    ce = -logp_true
    if class_weights is not None:
        w = class_weights.to(device=logits.device, dtype=torch.float32)[safe]
    else:
        w = torch.ones_like(ce)
    ce = torch.where(valid, ce * w, 0.0)

    if focal_gamma != 0.0:
        focal = torch.pow(1.0 - torch.exp(logp_true), focal_gamma)
        focal_ce = torch.where(valid, focal * ce, 0.0)
        if dp is None:
            return focal_ce.mean()
        return focal_ce.sum() / dp.total(torch.tensor(float(focal_ce.numel()),
                                                      device=logits.device))

    denom = torch.where(valid, w, 0.0).sum()
    return ce.sum() / _total(denom, dp).clamp_min(1e-12)


def _total(t: torch.Tensor, dp) -> torch.Tensor:
    """``t`` summed over the data-parallel ranks (itself without ``dp``)."""
    return t if dp is None else dp.total(t)


def bce_with_logits_ignore(
    logits: torch.Tensor, labels: torch.Tensor, ignore_id: int = IGNORE, dp=None,
) -> torch.Tensor:
    """Mean binary cross-entropy with logits over valid positions (``dp``:
    this rank's share under data parallel)."""
    logits = logits.reshape(-1).float()
    labels = labels.reshape(-1)
    valid = labels != ignore_id
    y = torch.where(valid, labels, 0).float()
    loss = logits.clamp_min(0.0) - logits * y + torch.log1p(torch.exp(-logits.abs()))
    loss = torch.where(valid, loss, 0.0)
    return loss.sum() / _total(valid.sum(), dp).clamp_min(1)


def ts_class_weights(weight_label_zero: float) -> Optional[torch.Tensor]:
    """[w0, 1 - w0] for the 2-label topic-segmentation head, or None when
    w0 == 0.5 (the reference weights only then)."""
    if weight_label_zero == 0.5:
        return None
    return torch.tensor([weight_label_zero, 1.0 - weight_label_zero], dtype=torch.float32)
