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

Without a process group every function is the single-process identity.
"""

from __future__ import annotations

import logging
import os
from typing import List, Optional, Sequence

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
) -> bool:
    """Join the process group; returns True if this call made it.

    The address, world size and rank default to torchrun's environment
    (``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``); explicit
    ``init_method`` (``tcp://host:port``), ``num_processes`` and
    ``process_id`` override it. NCCL for a CUDA ``device`` (this process's
    card becomes ``cuda:LOCAL_RANK``), gloo for the CPU. With neither an
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
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", process_id or 0)))
    dist.init_process_group(backend, init_method=init_method, world_size=num_processes or 1,
                            rank=process_id or 0)
    logger.info("process group (%s): rank %d of %d", backend, rank(), world_size())
    return True


def process_device(device: str) -> torch.device:
    """``device`` for this process: ``cuda`` becomes ``cuda:LOCAL_RANK``
    inside a process group."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and is_distributed():
        return torch.device("cuda", local_rank())
    return dev


def _comm_device(t: torch.Tensor) -> torch.device:
    """Where a collective runs: on the card with NCCL, on the CPU with gloo."""
    return t.device if dist.get_backend() == "nccl" else torch.device("cpu")


def all_gather_tensors(t: torch.Tensor) -> List[torch.Tensor]:
    """Every rank's ``t`` (equal shapes), in rank order, on ``t``'s device."""
    x = t.detach().to(_comm_device(t)).contiguous()
    parts = [torch.empty_like(x) for _ in range(world_size())]
    dist.all_gather(parts, x)
    return [p.to(t.device) for p in parts]


class _GatherRows(torch.autograd.Function):
    """Rows of every rank concatenated along dim 0. Backward: the gradient of
    the whole is summed over the ranks (each rank's loss reads every row)
    and each rank keeps its own rows."""

    @staticmethod
    def forward(ctx, x):
        ctx.n = x.shape[0]
        return torch.cat(all_gather_tensors(x), 0)

    @staticmethod
    def backward(ctx, g):
        dev = g.device
        total = g.detach().to(_comm_device(g)).contiguous().clone()
        dist.all_reduce(total)
        r = rank()
        return total[r * ctx.n:(r + 1) * ctx.n].to(dev)


class DataParallel:
    """The data axis of the process group: this rank's share of a global
    batch, and the step's global reductions."""

    def __init__(self):
        self.world_size = world_size()
        self.rank = rank()

    def total(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the ranks, out of the graph (a loss's
        denominator)."""
        out = t.detach().to(_comm_device(t)).clone()
        dist.all_reduce(out)
        return out.to(t.device)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's rows, in rank order; differentiable."""
        return _GatherRows.apply(x)

    def gather_const(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's rows of a tensor with no gradient (labels, masks)."""
        return torch.cat(all_gather_tensors(x), 0)

    @torch.no_grad()
    def all_reduce_(self, tensors: Sequence[torch.Tensor]):
        """Sum each tensor over the ranks in place, in one all-reduce of one
        flat buffer a dtype."""
        by_dtype = {}
        for t in tensors:
            by_dtype.setdefault(t.dtype, []).append(t)
        for group in by_dtype.values():
            flat = torch.cat([t.reshape(-1) for t in group])
            comm = flat.to(_comm_device(flat))
            dist.all_reduce(comm)
            flat = comm.to(flat.device)
            offset = 0
            for t in group:
                t.copy_(flat[offset:offset + t.numel()].view_as(t))
                offset += t.numel()

    @torch.no_grad()
    def broadcast_(self, tensors: Sequence[torch.Tensor], src: int = 0):
        """Rank ``src``'s values into every rank's tensors."""
        for t in tensors:
            comm = t.to(_comm_device(t))
            dist.broadcast(comm, src)
            if comm is not t:
                t.copy_(comm)


def data_parallel() -> Optional[DataParallel]:
    """The data axis of the current process group, or None without one."""
    return DataParallel() if is_distributed() else None


def allgather_ragged(local_lists: Sequence[Sequence[int]]) -> List[List[int]]:
    """Every rank's ragged int lists, concatenated in rank order, on every
    rank (the reference's ``gather_for_metrics`` of prediction and label
    lists). One process: a copy."""
    local = [list(map(int, x)) for x in local_lists]
    if world_size() == 1:
        return local
    parts: List[Optional[list]] = [None] * world_size()
    dist.all_gather_object(parts, local)
    return [row for part in parts for row in part]


def gather_rows(local: np.ndarray, n: int, device: torch.device) -> np.ndarray:
    """Each rank's equal block of rows (``mesh.rank_rows``), concatenated in
    rank order on every rank and cut to the ``n`` real rows. The rows cross
    in float32 (exact for the engine's bfloat16 scores) over ``device``'s
    backend."""
    if world_size() == 1:
        return local[:n]
    t = torch.from_numpy(np.ascontiguousarray(local, np.float32)).to(device)
    out = torch.cat(all_gather_tensors(t), 0).cpu().numpy()
    return out[:n].astype(local.dtype)


def barrier():
    if is_distributed():
        dist.barrier()


def destroy():
    if is_distributed():
        dist.destroy_process_group()
