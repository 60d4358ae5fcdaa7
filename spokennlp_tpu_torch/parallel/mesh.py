"""The data axis: which rows of a global batch each rank takes.

Counterpart of the data half of ``spokennlp_tpu/parallel/mesh.py``. JAX
shards the leading axis of every batch tensor over a mesh's ``data`` axis
and replicates the CSSL list-mode index tensors, whose indices point into
the whole batch; here each rank of the process group takes its contiguous
block of rows, in rank order, and keeps those tensors whole. The
``model`` axis (tensor parallel) is a later slice of the port: the fused
kernels take whole weights and fuse the out projection with the residual
and the LayerNorm, so a head split would need an all-reduce inside them.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

DATA_AXIS = "data"

REPLICATED_BATCH_PREFIXES = ("cssl_", "topic_cl_")
"""Batch keys that are not batch-leading: the CSSL list-mode index tensors
are flattened (B*K) / (k, B*K) gather indices into the whole batch's eop
features (data/cssl_sampling.py); every rank keeps them whole."""


def check_model_parallel(model_parallel_size: int):
    if model_parallel_size != 1:
        raise NotImplementedError(
            f"model_parallel_size={model_parallel_size}: the port has the data axis only; "
            "tensor parallel (the model axis) is a later slice")


def shard_batch(batch: Dict[str, np.ndarray], rank: int, world_size: int) -> Dict[str, np.ndarray]:
    """Rank ``rank``'s rows of every batch tensor (its contiguous block of
    the leading axis), keys matching REPLICATED_BATCH_PREFIXES whole. The
    leading axis must divide by ``world_size``: callers pad short batches
    first (``batches_from_docs`` repeats the last row)."""
    out = {}
    for key, x in batch.items():
        if key.startswith(REPLICATED_BATCH_PREFIXES):
            out[key] = x
            continue
        n = np.shape(x)[0]
        if n % world_size:
            raise ValueError(f"batch axis {n} (key {key!r}) not divisible by data-parallel size "
                             f"{world_size}; pad the batch (repeat rows) before sharding")
        per = n // world_size
        out[key] = x[rank * per:(rank + 1) * per]
    return out


def rank_rows(n: int, rank: int, world_size: int) -> Tuple[int, int]:
    """[start, end) of rank ``rank``'s block of ``ceil(n / world_size)`` of
    ``n`` rows, in rank order; ``end`` may pass ``n``: the engine repeats
    the last window there, so that every rank's block has one size, and the
    trainer's eval cuts the block at ``n``."""
    per = -(-n // world_size)
    return rank * per, (rank + 1) * per
