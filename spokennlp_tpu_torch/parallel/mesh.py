"""The data axis: which rows of a global batch each rank takes.

Counterpart of the data half of ``spokennlp_tpu/parallel/mesh.py``. JAX
shards the leading axis of every batch tensor over a mesh's ``data`` axis
and replicates the CSSL list-mode index tensors, whose indices point into
the whole batch; here each rank of the process group takes its contiguous
block of rows, in rank order, and keeps those tensors whole. The
``model`` axis (tensor parallel) is a later slice of the port: the fused
kernels take whole weights and fuse the out projection with the residual
and the LayerNorm, so a head split would need an all-reduce inside them.
Its expert rule is here: JAX shards the leading E axis of every MoE expert
stack over the ``model`` axis (``is_expert_param``, ``expert_range``), which
``dryrun.dryrun_moe_ep`` runs over a process group.
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


def is_expert_param(name: str) -> bool:
    """JAX's expert rule (``spokennlp_tpu/parallel/mesh.py`` ``param_partition_spec``):
    ``w_in`` / ``w_out`` under a module whose name holds "moe" is an (E, ...)
    expert stack whose leading axis shards over the ``model`` axis."""
    parts = name.split(".")
    return parts[-1] in ("w_in", "w_out") and any("moe" in p for p in parts[:-1])


def expert_range(rank: int, world_size: int, num_experts: int) -> range:
    """The experts rank ``rank`` holds of ``num_experts``: its contiguous
    block of E / n in rank order, as a NamedSharding of the leading axis
    over ``world_size`` devices places them. E must divide by n."""
    if num_experts % world_size:
        raise ValueError(f"{num_experts} experts do not divide over {world_size} ranks")
    per = num_experts // world_size
    return range(rank * per, (rank + 1) * per)
