"""Train step for topic segmentation.

Counterpart of ``make_topic_seg_train_step`` in
``spokennlp_tpu/train/train_step.py``: the anchor view's forward, the DA
view's forward (when DA or TSSP is on), the composite loss, the gradients,
and one optimizer call (clipping, accumulation, AdamW and the schedule).
PyTorch runs it eagerly; on the card the dense layers run the training
kernels (``attention_impl="train_fused"``).

Every dropout mask and kernel seed of a step comes from one
``torch.Generator`` on the model's device, seeded from (seed, micro-step,
rank), so a step is reproducible and a resumed run continues the same
streams.

Under data parallel (a ``torch.distributed`` process group; parallel/dist.py)
each rank runs the step on its rows of the global batch: the loss is its
share of the global loss (global denominators, CSSL over every rank's
features), the gradients are summed over the ranks in one coalesced
all-reduce before the gradient norm and the optimizer call, so clipping
reads the global norm as optax does after JAX's psum, and the metrics are
summed over the ranks. Every rank then takes the same AdamW step. DDP is
not used: it reduces in hooks of ``backward()``, where the step takes
``torch.autograd.grad``, and it would leave the gradient norm and the
losses to be reduced apart anyway; one all-reduce of one flat buffer a
step costs what DDP's buckets cost at this size.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from spokennlp_tpu_torch.configs import TopicSegConfig
from spokennlp_tpu_torch.models.topic_seg import compute_topic_seg_loss
from spokennlp_tpu_torch.parallel.dist import data_parallel
from spokennlp_tpu_torch.train.optim import TrainOptimizer, global_norm

CSSL_KEYS = {
    "cssl_anchor_indices": "anchor_indices",
    "cssl_positive_indices": "positive_indices",
    "cssl_negative_indices": "negative_indices",
    "cssl_anchor_valid": "anchor_valid",
}


def batch_to_device(batch: Dict[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    """numpy (B, 2, ...) batch -> tensors on ``device``."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device, non_blocking=True)
            for k, v in batch.items()}


def step_generator(device: torch.device, seed: int, step: int, rank: int = 0) -> torch.Generator:
    """The generator of one micro-step's dropout masks and kernel seeds
    (another stream on each data-parallel rank)."""
    return torch.Generator(device=device).manual_seed(seed * 1_000_003 + step + rank * 7_919)


def make_topic_seg_train_step(
    model: torch.nn.Module,
    task_cfg: TopicSegConfig,
    optimizer: TrainOptimizer,
    with_da: Optional[bool] = None,
    seed: int = 0,
) -> Callable[[Dict[str, torch.Tensor]], Dict[str, torch.Tensor]]:
    """Build ``train_step(batch) -> metrics``.

    ``batch`` holds the paired-view tensors (B, 2, ...) on the model's
    device: input_ids, attention_mask, token_type_ids, labels,
    sent_positions, sent_mask, eop_mask, pair_orders, and the cssl_* index
    tensors of list-mode CSSL. The metrics are the scalar losses and the
    micro-batch's gradient norm before clipping, as 0-d tensors on the device.
    Inside a process group ``batch`` holds this rank's rows (and the whole
    cssl_* tensors: ``parallel.mesh.shard_batch``) and the metrics are the
    global batch's.
    """
    if with_da is None:
        with_da = task_cfg.do_da_ts or task_cfg.do_tssp
    params = optimizer.params

    def apply_view(batch, view: int, generator):
        return model(
            batch["input_ids"][:, view],
            attention_mask=batch["attention_mask"][:, view],
            token_type_ids=batch["token_type_ids"][:, view],
            sent_positions=batch["sent_positions"][:, view],
            generator=generator,
        )

    def train_step(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        model.train()
        dp = data_parallel()
        device = batch["input_ids"].device
        generator = step_generator(device, seed, optimizer.micro_step, dp.rank if dp else 0)
        anchor_out = apply_view(batch, 0, generator)
        da_out = apply_view(batch, 1, generator) if with_da else None
        cssl_indices = None
        if "cssl_anchor_indices" in batch:
            cssl_indices = {v: batch[k] for k, v in CSSL_KEYS.items()}
        loss, aux = compute_topic_seg_loss(task_cfg, anchor_out, da_out, batch, cssl_indices, dp)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        # a parameter the loss does not reach (the TSSP head without TSSP)
        # gets a zero gradient, as jax.grad gives it: AdamW still decays it
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        metrics = {k: v.detach() for k, v in aux.items() if v.ndim == 0}
        if dp is not None:
            dp.all_reduce_(grads)
            names = sorted(metrics)
            shares = torch.stack([metrics[k].float() for k in names])
            dp.all_reduce_([shares])
            metrics = dict(zip(names, shares.unbind()))
        metrics["grad_norm"] = global_norm(grads)
        optimizer.step(grads)
        return metrics

    return train_step
