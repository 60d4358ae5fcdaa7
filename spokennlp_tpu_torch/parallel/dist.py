"""Data parallel over ``torch.distributed``: joining the process group, and
the collectives the train step, the trainer and the engine need.

Counterpart of ``spokennlp_tpu/parallel/dist.py`` (``initialize_distributed``,
``allgather_ragged``). The reference launches one process a GPU with
``torch.distributed.launch`` and gathers eval tensors with
``accelerator.gather_for_metrics``; so does the port: one process a card,
NCCL between cards, gloo between CPU processes. JAX's one SPMD step over a
mesh becomes one step a process on its rows of the global batch, with the
step's reductions made global here:

- ``DataParallel.total``: the all-reduced sum of a loss's denominator (a
  count of labels, of weights), so that each rank's loss is its numerator
  over the global denominator and the ranks' losses add up to the
  single-process loss;
- ``DataParallel.gather``: rows of every rank, concatenated in rank order,
  differentiable (the CSSL losses index the whole batch's features);
- ``DataParallel.all_reduce_``: the gradients summed over the ranks, in one
  coalesced all-reduce.

The model axis (``--model_parallel_size`` mp > 1) follows JAX's
``make_mesh``: the n ranks form an (n // mp, mp) grid, rank r at data line
r // mp and model index r % mp (``Mesh``, made once by ``make_mesh``). The
data axis's reductions run over the ranks of one model index (the data
group), the model axis's over the ranks of one data line (the model group):

- ``ModelAxis.copy``: the identity whose backward sums the gradient over
  the model group (a replicated input of a sharded product);
- ``ModelAxis.reduce``: the sum of the ranks' partial products, whose
  backward is the identity (every model rank's loss reads the sum);
- ``ModelAxis.gather``: a sharded weight made whole for a kernel that takes
  whole weights; its backward keeps this rank's slice of the gradient,
  which every model rank computes alike from the same rows.

``sharded_batch(dp)`` marks a forward that runs on this rank's rows of a
global batch: ``draw_rand`` then draws its random numbers (dropout masks,
SLD's time masks) over the whole global batch from the one generator every
rank seeds alike and keeps this rank's rows, so the masks are the
single-process ones; the MoE plans its dispatch over every rank's tokens.

Without a process group every function is the single-process identity.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

logger = logging.getLogger("spokennlp_tpu_torch.dist")


def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if is_distributed() else 1


def rank() -> int:
    return dist.get_rank() if is_distributed() else 0


def local_rank() -> int:
    """This process's card on its host: torchrun's ``LOCAL_RANK``, else the
    rank."""
    return int(os.environ.get("LOCAL_RANK", rank()))


def initialize_distributed(
    device: str = "cuda",
    init_method: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
) -> bool:
    """Join the process group; returns True if this call made it.

    The address, world size and rank default to torchrun's environment
    (``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``); explicit
    ``init_method`` (``tcp://host:port``), ``num_processes`` and
    ``process_id`` override it. ``backend`` defaults to NCCL for a CUDA
    ``device`` (this process's card becomes ``cuda:LOCAL_RANK``) and gloo
    for the CPU; gloo with a CUDA device runs several ranks on one card
    (NCCL refuses two ranks on one GPU), its collectives through the host.
    With neither an
    environment nor arguments, or with a group already made, it does
    nothing and returns False."""
    if is_distributed():
        return False
    env_np = os.environ.get("WORLD_SIZE")
    if num_processes is None and env_np:
        num_processes = int(env_np)
    if process_id is None and os.environ.get("RANK"):
        process_id = int(os.environ["RANK"])
    if init_method is None and num_processes is None:
        return False  # one process
    if init_method is None:
        addr = os.environ.get("MASTER_ADDR", "localhost")
        init_method = f"tcp://{addr}:{os.environ.get('MASTER_PORT', '29500')}"
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", process_id or 0)))
    dist.init_process_group(backend, init_method=init_method, world_size=num_processes or 1,
                            rank=process_id or 0)
    logger.info("process group (%s): rank %d of %d", backend, rank(), world_size())
    return True


def process_device(device: str) -> torch.device:
    """``device`` for this process: ``cuda`` becomes ``cuda:LOCAL_RANK``
    inside a process group, ``cuda:0`` for every rank when ``LOCAL_RANK``
    passes the card count (ranks sharing one card over gloo)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and is_distributed():
        index = local_rank()
        return torch.device("cuda", index if index < torch.cuda.device_count() else 0)
    return dev


def _comm_device(t: torch.Tensor) -> torch.device:
    """Where a collective runs: on the card with NCCL, on the CPU with gloo."""
    return t.device if dist.get_backend() == "nccl" else torch.device("cpu")


def _all_reduce(t: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``t`` over ``group``, out of the graph, on ``t``'s device."""
    out = t.detach().to(_comm_device(t)).contiguous().clone()
    dist.all_reduce(out, group=group)
    return out.to(t.device)


def all_gather_tensors(t: torch.Tensor, group=None) -> List[torch.Tensor]:
    """Every rank's ``t`` (equal shapes) of ``group`` (the world by
    default), in rank order, on ``t``'s device."""
    x = t.detach().to(_comm_device(t)).contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return [p.to(t.device) for p in parts]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place on JAX's (data, model) grid of ``data_size`` x
    ``model_size`` ranks: rank = data_index * model_size + model_index. The
    groups are None without a model axis (the data axis is then the whole
    world)."""

    data_size: int = 1
    model_size: int = 1
    data_index: int = 0
    model_index: int = 0
    data_group: object = None
    model_group: object = None

    @property
    def data_ranks(self) -> List[int]:
        """The global ranks of this rank's data group, in data order."""
        return [d * self.model_size + self.model_index for d in range(self.data_size)]


_MESH: Optional[Mesh] = None


def make_mesh(model_parallel_size: int = 1) -> Mesh:
    """Lay the process group out as JAX's ``make_mesh`` lays out its devices
    ((n // mp, mp), axes data and model) and make it current; every rank
    calls it (it makes one group a data and a model line). mp must divide
    the world size."""
    from spokennlp_tpu_torch.parallel.mesh import check_model_parallel

    global _MESH
    n, r, mp = world_size(), rank(), model_parallel_size
    check_model_parallel(mp, n)
    if mp == 1 or not is_distributed():
        _MESH = Mesh(data_size=n, data_index=r)
        return _MESH
    dp = n // mp
    data_group = model_group = None
    for m in range(mp):  # every rank makes every group, in one order
        g = dist.new_group([d * mp + m for d in range(dp)])
        if r % mp == m:
            data_group = g
    for d in range(dp):
        g = dist.new_group([d * mp + m for m in range(mp)])
        if r // mp == d:
            model_group = g
    _MESH = Mesh(dp, mp, r // mp, r % mp, data_group, model_group)
    logger.info("mesh (data %d, model %d): rank %d at (%d, %d)", dp, mp, r, r // mp, r % mp)
    return _MESH


def mesh() -> Mesh:
    """The current mesh: the one ``make_mesh`` made, else every rank on the
    data axis."""
    if _MESH is not None and is_distributed():
        return _MESH
    return Mesh(data_size=world_size(), data_index=rank())


def data_size() -> int:
    """The data axis's size: the world size over the model axis's."""
    return mesh().data_size


def data_rank() -> int:
    """This rank's index on the data axis (its block of a global batch)."""
    return mesh().data_index


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, index):
        ctx.dim, ctx.index, ctx.n = dim, index, x.shape[dim]
        return torch.cat(all_gather_tensors(x, group), dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.index * ctx.n, ctx.n).contiguous(), None, None, None


@dataclasses.dataclass(frozen=True)
class ModelAxis:
    """The model group of one data line: its size, this rank's index in it,
    and the differentiable collectives of a sharded layer."""

    size: int
    index: int
    group: object

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        return _CopyToModel.apply(x, self.group)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        return _ReduceFromModel.apply(x, self.group)

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        return _GatherFromModel.apply(x, dim, self.group, self.index)

    def total(self, t: torch.Tensor) -> torch.Tensor:
        return _all_reduce(t, self.group)


def model_axis() -> Optional[ModelAxis]:
    """The current mesh's model axis, or None when it has one rank."""
    m = mesh()
    return ModelAxis(m.model_size, m.model_index, m.model_group) if m.model_size > 1 else None


class _GatherRows(torch.autograd.Function):
    """Rows of every rank concatenated along dim 0. Backward: the gradient of
    the whole is summed over the ranks (each rank's loss reads every row)
    and each rank keeps its own rows."""

    @staticmethod
    def forward(ctx, x, group, index):
        ctx.n, ctx.group, ctx.index = x.shape[0], group, index
        return torch.cat(all_gather_tensors(x, group), 0)

    @staticmethod
    def backward(ctx, g):
        total = _all_reduce(g, ctx.group)
        return total[ctx.index * ctx.n:(ctx.index + 1) * ctx.n], None, None


class _SumRanks(torch.autograd.Function):
    """The sum over the ranks; backward: the gradient summed over the ranks
    (each rank's loss reads the sum)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class DataParallel:
    """The data axis of the process group: this rank's share of a global
    batch, and the step's global reductions over the data group."""

    def __init__(self):
        m = mesh()
        self.world_size, self.rank, self.group = m.data_size, m.data_index, m.data_group
        self.src = m.data_ranks[0]

    def total(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the ranks, out of the graph (a loss's
        denominator)."""
        return _all_reduce(t, self.group)

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the ranks, differentiable (a sum over the
        global batch that every rank's loss share reads)."""
        return _SumRanks.apply(t, self.group)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's rows, in rank order; differentiable."""
        return _GatherRows.apply(x, self.group, self.rank)

    def gather_const(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's rows of a tensor with no gradient (labels, masks)."""
        return torch.cat(all_gather_tensors(x, self.group), 0)

    @torch.no_grad()
    def all_reduce_(self, tensors: Sequence[torch.Tensor]):
        """Sum each tensor over the ranks in place, in one all-reduce of one
        flat buffer a dtype."""
        by_dtype = {}
        for t in tensors:
            by_dtype.setdefault(t.dtype, []).append(t)
        for group in by_dtype.values():
            flat = _all_reduce(torch.cat([t.reshape(-1) for t in group]), self.group)
            offset = 0
            for t in group:
                t.copy_(flat[offset:offset + t.numel()].view_as(t))
                offset += t.numel()

    @torch.no_grad()
    def broadcast_(self, tensors: Sequence[torch.Tensor]):
        """The first rank of the data group's values into every rank's
        tensors (each model index broadcasts its own shards)."""
        for t in tensors:
            comm = t.to(_comm_device(t))
            dist.broadcast(comm, self.src, group=self.group)
            if comm is not t:
                t.copy_(comm)


def data_parallel() -> Optional[DataParallel]:
    """The data axis of the current process group, or None without one."""
    return DataParallel() if is_distributed() else None


_BATCH: List[Optional[DataParallel]] = [None]


@contextlib.contextmanager
def sharded_batch(dp: Optional[DataParallel]):
    """Within: the forward runs on ``dp``'s rank's rows of a global batch
    (``draw_rand``, the MoE's dispatch plan); None, or a data axis of one
    rank, changes nothing."""
    prev = _BATCH[0]
    _BATCH[0] = dp if dp is not None and dp.world_size > 1 else None
    try:
        yield
    finally:
        _BATCH[0] = prev


def batch_dp() -> Optional[DataParallel]:
    """The data axis of the global batch the current forward shards
    (``sharded_batch``), or None."""
    return _BATCH[0]


def draw_rand(shape: Tuple[int, ...], generator: Optional[torch.Generator],
              device) -> torch.Tensor:
    """``torch.rand(shape)`` whose leading axis is this rank's rows of the
    global batch: under ``sharded_batch`` it draws the global batch's
    numbers and keeps this rank's block, so they are the single-process
    ones; elsewhere the plain draw."""
    dp = batch_dp()
    if dp is None:
        return torch.rand(shape, generator=generator, device=device)
    B = shape[0]
    full = torch.rand((B * dp.world_size, *shape[1:]), generator=generator, device=device)
    return full[dp.rank * B:(dp.rank + 1) * B]


def rank_seed(seed: torch.Tensor) -> torch.Tensor:
    """A training kernel's dropout seed for this rank's rows: under
    ``sharded_batch`` every rank draws the same seed, and the kernels key
    their masks on the rows they hold, so each data rank moves its seed on
    by its index (model ranks of one data line keep it alike)."""
    dp = batch_dp()
    if dp is None or dp.rank == 0:
        return seed
    return (seed.long() + dp.rank * 1_000_003) % (2**31 - 1)


def allgather_ragged(local_lists: Sequence[Sequence[int]]) -> List[List[int]]:
    """Every data rank's ragged int lists, concatenated in rank order, on
    every rank (the reference's ``gather_for_metrics`` of prediction and
    label lists). One data rank: a copy."""
    local = [list(map(int, x)) for x in local_lists]
    m = mesh()
    if m.data_size == 1:
        return local
    parts: List[Optional[list]] = [None] * m.data_size
    dist.all_gather_object(parts, local, group=m.data_group)
    return [row for part in parts for row in part]


def gather_rows(local: np.ndarray, n: int, device: torch.device) -> np.ndarray:
    """Each data rank's equal block of rows (``mesh.rank_rows``),
    concatenated in rank order on every rank and cut to the ``n`` real rows.
    The rows cross in float32 (exact for the engine's bfloat16 scores) over
    ``device``'s backend."""
    m = mesh()
    if m.data_size == 1:
        return local[:n]
    t = torch.from_numpy(np.ascontiguousarray(local, np.float32)).to(device)
    out = torch.cat(all_gather_tensors(t, m.data_group), 0).cpu().numpy()
    return out[:n].astype(local.dtype)


def barrier():
    if is_distributed():
        dist.barrier()


def destroy():
    global _MESH
    _MESH = None
    if is_distributed():
        dist.destroy_process_group()
