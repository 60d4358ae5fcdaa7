"""The (data, model) axes: which rows of a global batch each rank takes,
and which slice of each parameter.

Counterpart of ``spokennlp_tpu/parallel/mesh.py``. JAX shards the leading
axis of every batch tensor over a mesh's ``data`` axis and replicates the
CSSL list-mode index tensors, whose indices point into the whole batch;
here each data rank of the process group takes its contiguous block of
rows, in data order, and keeps those tensors whole (the ranks of one data
line take the same rows).

The ``model`` axis follows JAX's partition rule, keyed on the parameter's
path (the port's names follow the Flax tree; ``param_partition_dim``):
heads of ``qkv`` (H, 3, nh, hd) and of the attention's ``out`` (nh, hd, H),
``mlp_in``'s columns, ``mlp_out``'s rows, the leading E axis of an MoE's
expert stacks, everything else whole. ``shard_module_`` replaces each such
parameter by this rank's slice and marks it (``model_shard``); the layers
read the mark (models/encoder.py, models/multimodal.py): the einsum path
computes its heads' and columns' share and sums it over the model group,
the fused kernels take the weights gathered whole.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np

DATA_AXIS = "data"

REPLICATED_BATCH_PREFIXES = ("cssl_", "topic_cl_")
"""Batch keys that are not batch-leading: the CSSL list-mode index tensors
are flattened (B*K) / (k, B*K) gather indices into the whole batch's eop
features (data/cssl_sampling.py); every rank keeps them whole."""


def check_model_parallel(model_parallel_size: int, world_size: int = 1):
    """Raise unless ``--model_parallel_size`` divides the world size."""
    if model_parallel_size < 1 or world_size % model_parallel_size:
        raise ValueError(
            f"--model_parallel_size {model_parallel_size} does not divide the world size "
            f"{world_size} (the mesh is (world // mp, mp), as JAX's make_mesh lays it out)")


def param_partition_dim(name: str, ndim: int) -> Optional[int]:
    """The axis of the parameter ``name`` (dotted, the Flax path's parts)
    that JAX's ``param_partition_spec`` shards over ``model``, or None when
    it stays whole. The tests are JAX's: "qkv" and "mlp_in"/"mlp_out" must
    be parts of the path (so ``qkv_global`` stays whole), "out" a part with
    "attention" anywhere in the joined path."""
    names = name.split(".")
    leaf, joined = names[-1], "/".join(names)
    if "qkv" in names:
        return 2 if ndim == 4 else 1
    if "out" in names and "attention" in joined:
        return 0 if ndim == 3 else None
    if "mlp_in" in names:
        return 1 if leaf == "kernel" else 0
    if "mlp_out" in names:
        return 0 if leaf == "kernel" else None
    if leaf in ("w_in", "w_out") and any("moe" in n for n in names):
        return 0
    return None


def shard_slice(x, dim: int, index: int, size: int):
    """Block ``index`` of ``size`` equal blocks of the tensor ``x`` along
    ``dim``."""
    n = x.shape[dim]
    if n % size:
        raise ValueError(f"axis {dim} of length {n} does not divide over {size} model ranks")
    per = n // size
    return x.narrow(dim, index * per, per)


SHARD_AWARE = {"TransformerLayer", "SelfAttention", "DenseSelfAttentionLayer",
               "CrossAttentionLayer", "MoELayer"}
"""The layers whose forward reads the marks (models/encoder.py,
models/multimodal.py): a parameter JAX's rule shards must sit in one of
them (or in a projection of one), else ``shard_module_`` raises."""


def _owner_aware(module, name: str) -> bool:
    """Whether the parameter ``name`` sits in a SHARD_AWARE layer or in a
    direct child of one."""
    parts = name.split(".")
    return any(type(module.get_submodule(".".join(parts[:k]))).__name__ in SHARD_AWARE
               for k in (len(parts) - 1, len(parts) - 2) if k >= 0)


def shard_module_(module, axis) -> int:
    """Replace every parameter JAX's rule shards by this rank's slice (in
    place, before the optimizer is made) and mark it ``model_shard = (dim,
    axis)``; returns how many. ``axis`` is ``dist.model_axis()``; None
    leaves the module whole. A parameter the rule shards in a layer that
    cannot run sharded raises before anything is cut."""
    if axis is None:
        return 0
    named = [(name, p, param_partition_dim(name, p.ndim))
             for name, p in module.named_parameters()]
    blind = [name for name, _, dim in named if dim is not None and not _owner_aware(module, name)]
    if blind:
        raise NotImplementedError(
            f"--model_parallel_size {axis.size}: {blind[:3]} would be sharded by JAX's rule but "
            "their layer has no model-parallel path in the port")
    n = 0
    for name, p, dim in named:
        if dim is None:
            continue
        p.data = shard_slice(p.data, dim, axis.index, axis.size).contiguous()
        p.model_shard = (dim, axis)
        n += 1
    return n


def shard_axis(p) -> Optional[object]:
    """The model axis a parameter is sharded over, or None when whole."""
    mark = getattr(p, "model_shard", None)
    return mark[1] if mark is not None else None


def whole(p):
    """``p`` whole: gathered over the model group when sharded
    (differentiable: the backward keeps this rank's slice)."""
    mark = getattr(p, "model_shard", None)
    return p if mark is None else mark[1].gather(p, mark[0])


def gather_state_dict(module) -> Dict:
    """The module's ``state_dict`` with every sharded parameter gathered
    whole (the same on every model rank): what a checkpoint holds."""
    import torch

    from spokennlp_tpu_torch.parallel.dist import all_gather_tensors

    marks = {n: getattr(p, "model_shard", None) for n, p in module.named_parameters()}
    out = {}
    for name, t in module.state_dict().items():
        mark = marks.get(name)
        if mark is not None:
            t = torch.cat(all_gather_tensors(t, mark[1].group), mark[0])
        out[name] = t
    return out


def shard_state_dict(state: Mapping, module) -> Dict:
    """A whole ``state_dict`` (a checkpoint's) cut to ``module``'s sharded
    parameters: each marked one takes this rank's slice."""
    marks = {n: getattr(p, "model_shard", None) for n, p in module.named_parameters()}
    out = {}
    for name, t in state.items():
        mark = marks.get(name)
        out[name] = t if mark is None else shard_slice(t, mark[0], mark[1].index,
                                                       mark[1].size).contiguous()
    return out


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


def _map_optimizer_state(state: Dict, optimizer, fn) -> Dict:
    """``TrainOptimizer.state_dict()`` with ``fn(tensor, mark)`` applied to
    each moment of a marked parameter; ``optimizer`` is the torch optimizer
    whose groups list the parameters in the state's index order."""
    inner = state["optimizer"]
    params = [p for g in optimizer.param_groups for p in g["params"]]
    marks = {i: getattr(p, "model_shard", None) for i, p in enumerate(params)}
    moments = {}
    for i, entry in inner["state"].items():
        mark = marks.get(int(i))
        moments[i] = {k: (fn(v, mark) if mark is not None and getattr(v, "ndim", 0) else v)
                      for k, v in entry.items()}
    return {**state, "optimizer": {**inner, "state": moments}}


def gather_optimizer_state(state: Dict, optimizer) -> Dict:
    """The optimizer's moments of sharded parameters gathered whole."""
    import torch

    from spokennlp_tpu_torch.parallel.dist import all_gather_tensors

    return _map_optimizer_state(
        state, optimizer, lambda t, m: torch.cat(all_gather_tensors(t, m[1].group), m[0]))


def shard_optimizer_state(state: Dict, optimizer) -> Dict:
    """Whole moments cut to this rank's slices of the sharded parameters."""
    return _map_optimizer_state(
        state, optimizer, lambda t, m: shard_slice(t, m[0], m[1].index, m[1].size).contiguous())
